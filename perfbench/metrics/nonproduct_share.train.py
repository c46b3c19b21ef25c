"""Device time outside matrix products and the port's kernels, in %."""
from harness import readers


def read(run):
    return readers.nonproduct_share(run)
