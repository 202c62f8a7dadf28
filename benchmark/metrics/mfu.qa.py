"""The QA batch's share of the bf16 peak: the model FLOPs of the window's batches
(benchmark/counts.qa_batch_flops) over the window's seconds and 989 TFLOP/s, %."""
from benchmark.readers import mfu


def read(r):
    return mfu(r)
