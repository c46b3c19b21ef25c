"""Share of the traced window with no device activity, in %."""
from harness import readers


def read(run):
    return readers.idle_share(run)
