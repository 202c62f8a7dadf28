"""Optimizer milliseconds an update (train/trainer.Optimizer, adam8bit): the host clock around
each synchronised Optimizer.update call of the window, summed, over the updates it applied."""
from benchmark.readers import span_ms_per


def read(r):
    return span_ms_per(r, "optimizer", "updates")
