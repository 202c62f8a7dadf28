"""Kernel 2 (csrc/decode_attention.cu) in a QA window, a launch a layer a decode step: the roofline
bound over the device time, %."""
from benchmark.readers import roofline


def read(r):
    return roofline(r, "decode_attention")
