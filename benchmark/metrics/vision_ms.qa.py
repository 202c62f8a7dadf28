"""Milliseconds a batch in batching.spliced_prompt (VGGT, Perceiver, embed, splice): the host clock
around each synchronised call of the window, summed, over the batches."""
from benchmark.readers import span_ms_per


def read(r):
    return span_ms_per(r, "vision", "batches")
