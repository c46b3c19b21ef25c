"""Model operations of the window's steps (three forwards) over the bf16 peak, in %."""
from harness import readers


def read(run):
    return readers.mfu(run)
