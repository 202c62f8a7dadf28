"""Train-state checkpoints as ``torch.save`` state-dict files (counterpart of
``vggt_qwen3_tpu/train/checkpoint.py``, which writes Orbax directories).

``<output_dir>/step_<n>/`` holds ``params.pt`` (the nested parameter dict,
what inference restores) and ``train_state.pt`` (the optimizer state and the
step). A save writes into ``step_<n>.tmp/`` and renames it when complete, so
:func:`latest_step_dir` never picks up a half-written step.

A sharded state (DTensor leaves) is saved as full tensors: every rank joins
the gathers and rank 0 writes, so a checkpoint is the same file whatever the
mesh. :func:`restore` with ``mesh`` lays it out again by the registry, on any
mesh shape.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..parallel.sharding import full
from .trainer import TrainState, shard_state, state_shardings


@torch.no_grad()
def _full(tree):
    """A copy of a nested dict with every DTensor gathered whole (a
    collective: every rank calls it)."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return full(tree) if isinstance(tree, DTensor) else tree


def save(state: TrainState, path: str | Path) -> None:
    """Write ``state`` to ``path`` (full tensors; under a process group every
    rank calls this and rank 0 writes, the others waiting until it has)."""
    path = Path(path)
    params, opt_state = _full(state.params), _full(state.opt_state)
    if not dist.is_initialized() or dist.get_rank() == 0:
        tmp = path.with_name(path.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(params, tmp / "params.pt")
        torch.save({"opt_state": opt_state, "step": state.step}, tmp / "train_state.pt")
        os.replace(tmp, path)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def load_params(path: str | Path, device="cuda"):
    """The parameter tree of a ``step_<n>`` directory, on ``device`` (raises
    for CUDA without a card)."""
    return torch.load(Path(path) / "params.pt", map_location=resolve_device(device), weights_only=True)


def restore(path: str | Path, device="cuda", mesh=None) -> TrainState:
    """The whole train state of a ``step_<n>`` directory, on ``device``; with
    ``mesh``, laid out on it by the registry (``trainer.state_shardings``)."""
    device = resolve_device(device)
    rest = torch.load(Path(path) / "train_state.pt", map_location=device, weights_only=True)
    state = TrainState(params=load_params(path, device), opt_state=rest["opt_state"], step=int(rest["step"]))
    return state if mesh is None else shard_state(state, state_shardings(state, mesh))


def latest_step_dir(output_dir: str | Path) -> Optional[Path]:
    """The newest complete ``step_<n>`` directory under ``output_dir``, or None."""
    output_dir = Path(output_dir)
    best, best_step = None, -1
    if not output_dir.exists():
        return None
    for child in output_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", child.name)
        if m and child.is_dir() and int(m.group(1)) > best_step:
            best, best_step = child, int(m.group(1))
    return best
