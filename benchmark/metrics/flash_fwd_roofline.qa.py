"""Kernel 1 (csrc/flash_fwd.cu) in a QA window, the tower's launches and the prefill's: the roofline
bound over the device time, %."""
from benchmark.readers import roofline


def read(r):
    return roofline(r, "flash_fwd")
