"""Profiling (counterpart of ``vggt_qwen3_tpu/utils/profiling.py``) over
``torch.profiler``.

    from vggt_qwen3_tpu_torch.utils.profiling import annotate, trace
    with trace("/tmp/profile"):
        with annotate("step"):
            step(...)

:func:`trace` records the host and, where a CUDA device is present, the
card (CPU and CUDA activities) and writes one Chrome/Perfetto trace
(``trace_<pid>_<n>.json``, open it in ``ui.perfetto.dev`` or
``chrome://tracing``) into ``logdir``. :func:`annotate` is a named range in
that trace (``torch.profiler.record_function``). JAX's :func:`start_server`
(a profiler server for on-demand capture from TensorBoard's profile plugin)
has no PyTorch counterpart: here it raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from pathlib import Path
from typing import Iterator

import torch

_count = itertools.count()


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the body; on exit write its trace into ``logdir`` (created)."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / f"trace_{os.getpid()}_{next(_count)}.json"))


def annotate(name: str) -> torch.profiler.record_function:
    """A named range in the trace."""
    return torch.profiler.record_function(name)


def start_server(port: int = 9012):
    """JAX's profiler server has no PyTorch counterpart."""
    raise NotImplementedError(
        "start_server: torch.profiler has no trace server for on-demand capture (JAX's jax.profiler."
        "start_server); wrap the code to profile in utils.profiling.trace(logdir) instead")
