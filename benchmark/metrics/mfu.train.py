"""The training step's share of the bf16 peak: the model FLOPs of the window's micro steps
(benchmark/counts.train_step_flops) over the window's seconds and 989 TFLOP/s, %."""
from benchmark.readers import mfu


def read(r):
    return mfu(r)
