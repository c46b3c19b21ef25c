"""Host share of a step spent inside the train-step call, in %."""
from harness import readers


def read(run):
    return readers.enqueue_share(run)
