"""Host share of a request spent inside the prefill call, in %."""
from harness import readers


def read(run):
    return readers.enqueue_share(run)
