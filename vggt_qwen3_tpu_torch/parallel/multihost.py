"""Multi-process launch (counterpart of ``vggt_qwen3_tpu/parallel/multihost.py``).

One process drives one device: :func:`initialize` joins this process into a
``torch.distributed`` world over a TCP store (NCCL when the device is a
card, gloo on the CPU), and the mesh (``parallel/mesh.py``) spans every
rank. Each process reads only its own rows of the global batch (the
loader's ``shard_rank``/``shard_count`` contract); :func:`global_batch_from_local`
views them as one batch sharded over ``dp × fsdp`` without a host gather.

The address, world size and rank are passed, or read from the variables
``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``), as JAX reads its ``JAX_*`` variables. A process's card is
``LOCAL_RANK`` (0 by default).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .sharding import batch_sharding


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: str = "cuda",
    timeout_s: float = 600.0,
) -> None:
    """Join the world. No-op when a process group already exists.

    ``coordinator_address`` is ``host:port`` (rank 0 serves the store there);
    ``device_type`` picks the backend: NCCL for ``cuda`` (this process's
    card becomes ``LOCAL_RANK``), gloo otherwise."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    host, port = coordinator_address.rsplit(":", 1)
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0, timeout=timeout)
    backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes, timeout=timeout)


def global_batch_from_local(local_batch: Any, mesh) -> Any:
    """This process's rows (tensors on its device) as DTensors of the global
    batch, rows sharded over ``dp × fsdp`` (``DTensor.from_local``: no
    gather). Non-tensor leaves pass through."""
    placements = batch_sharding(mesh).placements

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor) and x.ndim >= 1:
            return DTensor.from_local(x, mesh, placements, run_check=False)
        return x

    return one(local_batch)
