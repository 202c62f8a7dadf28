"""Train-state checkpoints as ``torch.distributed.checkpoint`` directories
(counterpart of ``vggt_qwen3_tpu/train/checkpoint.py``, which writes Orbax
directories).

``<output_dir>/step_<n>/`` is one DCP checkpoint of ``{"params": the nested
parameter dict, "opt_state": the optimizer state, "step": n}`` and the
leaves' names in the tree's order (``"leaves"``: the order the trainer sums
in, which DCP's metadata does not keep): a ``.metadata`` file (every leaf's
name, global shape, dtype and the chunks it was written in) and a
``__<rank>_0.distcp`` file a rank. Under a process group every rank writes
the shards it holds and nothing is gathered; a leaf that several ranks hold
whole (or a chunk they share) is written once. A save writes into
``step_<n>.tmp/`` and renames it when complete, so :func:`latest_step_dir`
never picks up a half-written step.

:func:`restore` with ``mesh`` lays out an empty state on it by the registry
(``trainer.allocate_state``, from the shapes in the metadata) and reads each
rank's shards straight into it, on any mesh shape (DCP reshards on load);
without a mesh it reads whole tensors in this process alone, as
:func:`load_params` does for inference. A failed write or read raises.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

from .. import resolve_device
from .trainer import TrainState, allocate_state

METADATA = ".metadata"  # the file that makes a directory a checkpoint (DCP's name)


def _world() -> bool:
    """True under a process group of more than this process."""
    return dist.is_initialized() and dist.get_world_size() > 1


@contextlib.contextmanager
def _quiet() -> Iterator[None]:
    """DCP warns on every call in a process without a process group; here
    that is meant (a single process reads or writes alone)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _names(tree, prefix: str = "") -> List[str]:
    """DCP's name of every leaf of ``tree`` (its keys joined with "."), in
    order; a key holding a "." would make two leaves one name."""
    out = []
    for k, v in tree.items():
        if "." in str(k):
            raise ValueError(f"checkpoint key {prefix}{k!r} holds a '.'")
        out += _names(v, f"{prefix}{k}.") if isinstance(v, dict) else [f"{prefix}{k}"]
    return out


def _write(tree: Dict[str, Any], path: Path, *, replace: bool = False) -> None:
    """``tree`` as a DCP checkpoint at ``path`` through ``<path>.tmp``; under a
    process group every rank calls this with its own shards. ``replace``: an
    existing ``path`` is removed once the new one is complete."""
    tree = dict(tree, leaves=_names(tree))
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    first = not dist.is_initialized() or dist.get_rank() == 0
    if first:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    if _world():
        dist.barrier()
    with _quiet():
        dcp.save(tree, storage_writer=dcp.FileSystemWriter(tmp), no_dist=not dist.is_initialized())
    if first:
        if replace and path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    if _world():
        dist.barrier()


def save(state: TrainState, path: str | Path) -> None:
    """Write ``state`` to ``path`` (under a process group every rank calls
    this and writes its own shards)."""
    _write({"params": state.params, "opt_state": state.opt_state, "step": state.step}, Path(path))


def save_params(params, path: str | Path) -> None:
    """Write a parameter tree alone (no optimizer state) to ``path`` in the
    same format, replacing a checkpoint already there: what
    ``tools/convert_reference_ckpt.py`` writes for inference."""
    _write({"params": params}, Path(path), replace=True)


def is_step_dir(path: str | Path) -> bool:
    """Whether ``path`` is a checkpoint (a ``step_<n>`` directory) itself."""
    return (Path(path) / METADATA).is_file()


def _abstract(path: Path) -> Dict[str, Any]:
    """The checkpoint's tree in its order, from its metadata: every tensor a
    meta tensor of its global shape and dtype, every other value 0 (read on
    load)."""
    md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    order = {"leaves": None}
    _read(order, path, alone=True)
    tree: Dict[str, Any] = {}
    for fqn in order["leaves"]:
        *keys, last = fqn.split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        meta = md[fqn]
        node[last] = (torch.empty(meta.size, dtype=meta.properties.dtype, device="meta")
                      if isinstance(meta, TensorStorageMetadata) else 0)
    return tree


def _read(tree: Dict[str, Any], path: Path, *, alone: bool) -> None:
    """Fill ``tree`` (tensors in place, other values replaced) from the
    checkpoint at ``path``; ``alone``: this process reads without its group."""
    with _quiet():
        dcp.load(tree, storage_reader=dcp.FileSystemReader(path), no_dist=alone or not dist.is_initialized())


def load_params(path: str | Path, device="cuda"):
    """The parameter tree of a ``step_<n>`` directory, whole, on ``device``,
    read by this process alone (a checkpoint of any mesh; raises for CUDA
    without a card)."""
    device = resolve_device(device)
    path = Path(path)
    params = allocate_state(TrainState(params=_abstract(path)["params"], opt_state={}, step=0), device).params
    tree = {"params": params}
    _read(tree, path, alone=True)
    return tree["params"]


def restore(path: str | Path, device="cuda", mesh=None) -> TrainState:
    """The train state of a ``step_<n>`` directory on ``device``: with
    ``mesh`` (every rank of its group calls this), each rank's shards read
    straight into the registry's layout on it (``trainer.state_shardings``);
    without, whole tensors read by this process alone."""
    device = resolve_device(device)
    path = Path(path)
    tree = _abstract(path)
    if "opt_state" not in tree:
        raise ValueError(f"{path} holds parameters only (no optimizer state): read it with load_params")
    opt_state = tree["opt_state"]
    for key in ("acc", "mu", "nu"):  # an empty dict leaves no name in the metadata
        opt_state.setdefault(key, {})
    state = allocate_state(TrainState(params=tree["params"], opt_state=opt_state, step=0), device, mesh)
    tree = {"params": state.params, "opt_state": state.opt_state, "step": 0}
    _read(tree, path, alone=mesh is None)
    return TrainState(params=tree["params"], opt_state=tree["opt_state"], step=int(tree["step"]))


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
