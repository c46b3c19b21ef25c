"""BAD: the port importing jax or the JAX package, eagerly or lazily."""
import importlib

import jax                                      # T005
import jax.numpy as jnp                         # T005
from repro.sim import engine                    # T005
from jax import lax                             # T005


def lazy():
    import repro.kernels.sim_step               # T005: lazy import
    from repro import analysis                  # T005
    return importlib.import_module("repro.core.adaptive")   # T005
