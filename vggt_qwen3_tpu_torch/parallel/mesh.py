"""Device meshes over a ``torch.distributed`` world (counterpart of
``vggt_qwen3_tpu/parallel/mesh.py``).

One process drives one device, so a JAX mesh of devices becomes a
:class:`~torch.distributed.device_mesh.DeviceMesh` of ranks over the axes

- ``dp``   — data parallel (batch rows),
- ``fsdp`` — ZeRO-3: parameters and optimizer state sharded, batch rows too
  (all-gathered on use, gradients reduce-scattered back),
- ``tp``   — the registry's tensor-parallel storage split of the projections,
- ``pp``   — pipeline stages of the Qwen3 decoder stack (``parallel/pipeline.py``).

A rank's mesh coordinate follows its global rank in row-major order of
``(dp, fsdp, tp, pp)``, as JAX lays its devices out.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import MeshConfig

AXES = ("dp", "fsdp", "tp", "pp")
DATA_AXES = ("dp", "fsdp")  # the axes that split batch rows


def init_world_of_one(device_type: str = "cpu") -> None:
    """The default process group as this process alone, on an in-process
    store (no address): NCCL for CUDA, gloo for the CPU."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def build_mesh(cfg: Optional[MeshConfig] = None, device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(dp, fsdp, tp, pp)`` mesh over the world's ranks.

    With ``cfg=None`` every rank lands on ``fsdp`` (the ZeRO-3-like default).
    With no process group yet, the world is this process alone (NCCL for a
    CUDA ``device_type``, gloo otherwise). ``device_type`` defaults to the
    group's: ``cuda`` under NCCL, ``cpu`` under gloo."""
    if not dist.is_initialized():
        init_world_of_one(device_type or "cpu")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(dp=1, fsdp=n, tp=1)
    if cfg.num_devices != n:
        raise ValueError(f"mesh {cfg.shape} needs {cfg.num_devices} devices, have {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(cfg.shape), mesh_dim_names=AXES)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis: extent}``, as ``dict(jax_mesh.shape)``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    size = 1
    for a in axes:
        size *= mesh.size(mesh.mesh_dim_names.index(a))
    return size


def axis_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's index along ``axes`` taken together, row-major (``dp``
    before ``fsdp``: JAX's order of ``P(("dp", "fsdp"))``)."""
    idx = 0
    for a in axes:
        i = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def axis_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group of the ranks that differ only along ``axes``.

    One axis is the mesh's own group. Several axes make a group for every
    coordinate of the others (``dist.new_group`` is collective: every rank
    calls this with the same axes, in the same order); the groups are kept
    on the mesh, so each set of axes is made once."""
    names = mesh.mesh_dim_names
    sized = [a for a in axes if mesh.size(names.index(a)) > 1]
    if len(sized) <= 1:
        return mesh.get_group(sized[0] if sized else axes[-1])
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    key = tuple(axes)
    if key not in cache:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, axis_size(mesh, axes))
        me = dist.get_rank()
        for row in ranks.tolist():
            group = dist.new_group(row)
            if me in row:
                cache[key] = group
    return cache[key]
