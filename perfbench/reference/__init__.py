"""Plain references, one file a model family, in float32 PyTorch with
TF32 off.  They import nothing of the program: they read the
configuration's file (a dict) and the weights and inputs the benchmark
makes, and work out everything else again.  ``precision.Products`` runs
their weight products in float32 or, for the control, in fp8."""
