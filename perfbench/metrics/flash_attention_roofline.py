"""The flash kernel's calls' bound time over their device time, in %."""
from harness import readers


def read(run):
    return readers.roofline(run, "flash_attention")
