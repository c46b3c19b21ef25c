"""GOOD: the port imports torch, numpy and itself only."""
import importlib

import numpy as np
import torch

import repro_torch
from repro_torch.sim import engine


def lazy():
    from repro_torch.kernels import sim_step
    return importlib.import_module("repro_torch.core.adaptive"), sim_step
