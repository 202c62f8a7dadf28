"""Train-state checkpoints as ``torch.save`` state-dict files (counterpart of
``vggt_qwen3_tpu/train/checkpoint.py``, which writes Orbax directories).

``<output_dir>/step_<n>/`` holds ``params.pt`` (the nested parameter dict,
what inference restores) and ``train_state.pt`` (the optimizer state and the
step). A save writes into ``step_<n>.tmp/`` and renames it when complete, so
:func:`latest_step_dir` never picks up a half-written step.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Optional

import torch

from .trainer import TrainState


def save(state: TrainState, path: str | Path) -> None:
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(state.params, tmp / "params.pt")
    torch.save({"opt_state": state.opt_state, "step": state.step}, tmp / "train_state.pt")
    os.replace(tmp, path)


def load_params(path: str | Path, device="cpu"):
    """The parameter tree of a ``step_<n>`` directory, on ``device``."""
    return torch.load(Path(path) / "params.pt", map_location=device, weights_only=True)


def restore(path: str | Path, device="cpu") -> TrainState:
    """The whole train state of a ``step_<n>`` directory, on ``device``."""
    rest = torch.load(Path(path) / "train_state.pt", map_location=device, weights_only=True)
    return TrainState(params=load_params(path, device), opt_state=rest["opt_state"], step=int(rest["step"]))


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
