"""Kernel 1 (csrc/flash_fwd.cu) in a training window: its roofline bound over its device time, %."""
from benchmark.readers import roofline


def read(r):
    return roofline(r, "flash_fwd")
