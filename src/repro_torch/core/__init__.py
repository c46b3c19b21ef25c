"""Core model of the paper: Lambert W, Eqs. 6-11, estimators, controller."""
