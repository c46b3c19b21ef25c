"""Prompt tokens prefilled a second over the window (host clock)."""
from harness import readers


def read(run):
    return readers.tokens_per_s(run)
