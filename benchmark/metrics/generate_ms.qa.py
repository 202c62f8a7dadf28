"""Milliseconds a batch in engine.generate_early_exit (prefill and decode steps, host-paced): the
host clock around each synchronised call of the window, summed, over the batches."""
from benchmark.readers import span_ms_per


def read(r):
    return span_ms_per(r, "generate", "batches")
