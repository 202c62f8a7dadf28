"""Ring attention over a ``torch.distributed`` process group (counterpart of
``vggt_qwen3_tpu/ops/ring_attention.py``).

For VGGT's global attention over more than 16 views the sequence is sharded
over the ranks of a group: each rank holds ``[B, S/n]`` queries and
``[B, T/n]`` keys and values, attends its queries to the K/V shard it holds,
then passes that shard to rank + 1 and takes rank − 1's, n steps in all.
Each step is the port's flash forward with its logsumexp (kernel 1 on the
card, the plain version on the CPU); the chunks are merged as the JAX
module merges them:

    w_i = exp(lse_i − max_j lse_j) / Σ_j exp(lse_j − max_j lse_j),
    out = Σ_i w_i · out_i

in float32, a row that is dead in every chunk (lse ``NEG_INF``) kept at
weight 0, the sum cast to ``q.dtype``.

``torch.distributed``'s point-to-point calls carry no gradient, where JAX's
``ppermute`` has a transpose: the K/V rotation is an autograd function
(:class:`_Rotate`) whose backward sends the cotangent the other way (rank
− 1), so gradients reach q through each chunk's flash backward (which takes
the lse cotangent) and k/v through the rotations.

:func:`ring_attention_sharded` takes full tensors that every rank of the
group holds (or, with ``rows_sharded``, each rank its own batch rows, which
it gathers first and keeps again after). Its gradients follow JAX's
``shard_map`` transposes: the output all-gather's backward keeps this rank's
slice of the cotangent (every rank's is the same), and the slicing of the
replicated inputs becomes, in the backward, the all-gather of the slices'
cotangents.

A group of one rank runs one step and communicates nothing; then
:func:`ring_attention` equals the direct flash forward bit for bit. The
card runs the ring with one rank (NCCL cannot put two ranks on one card);
parity over several ranks is checked on the CPU with gloo.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import init_world_of_one
from ..parallel.sharding import gather, scatter
from .flash_attention import NEG_INF, flash_attention_with_lse


def _exchange(tensors: List[torch.Tensor], group, shift: int) -> List[torch.Tensor]:
    """Send each tensor to rank + ``shift`` of ``group`` and receive its
    counterpart from rank − ``shift``, all in one batch of P2P operations."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, frm, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


class _Rotate(torch.autograd.Function):
    """(k, v) of rank − 1, with the cotangents sent back to it in the
    backward."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_exchange([k, v], group, +1))

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = _exchange([dk, dv], ctx.group, -1)
        return None, dk, dv


def merge_chunks(outs: List[torch.Tensor], lses: List[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The logsumexp merge of chunk outputs ``[B, S, NH, D]`` with their lse
    ``[B, NH, S]`` (module note), in float32 (float64 for float64 chunks),
    cast to ``dtype``."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    lse = torch.stack(lses).to(acc)  # [n, B, NH, S]
    lse_max = lse.amax(0)
    w = torch.exp(lse - torch.where(lse_max <= NEG_INF * 0.5, torch.zeros_like(lse_max), lse_max))
    w = w / w.sum(0).clamp_min(1e-30)
    w = w.permute(0, 1, 3, 2)  # [n, B, S, NH]
    return (torch.stack(outs).to(acc) * w[..., None]).sum(0).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal ring attention over the ranks of ``group`` (default: the
    world).

    Args:
        q: this rank's shard ``[B, S/n, NH, D]``; k, v: its shards
            ``[B, T/n, NKV, D]``; shard i of the sequence on rank i.
    Returns:
        this rank's output shard ``[B, S/n, NH, D]`` in q.dtype.
    """
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    outs, lses = [], []
    kc, vc = k, v
    for step in range(n):
        out, lse = flash_attention_with_lse(q, kc, vc, scale=scale)
        outs.append(out)
        lses.append(lse)
        if step + 1 < n:
            kc, vc = _Rotate.apply(group, kc, vc)
    return merge_chunks(outs, lses, q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
                           scale: Optional[float] = None, rows_sharded: bool = False) -> torch.Tensor:
    """Ring attention over full (replicated) tensors, as the JAX module's
    ``shard_map`` wrapper: this rank takes its chunk of the sequence
    (``S`` and ``T`` must divide by the group's size), runs
    :func:`ring_attention` and all-gathers the output shards → ``[B, S, NH,
    D]`` on every rank. Differentiable (module note).

    ``rows_sharded``: each rank of ``group`` holds its own rows of the batch
    (a ring over a data axis of the mesh); the rows are all-gathered over the
    group before the ring and this rank's rows kept after, as XLA reshards
    around JAX's ``shard_map``."""
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    S, T = q.shape[1], k.shape[1]
    if S % n or T % n:
        raise ValueError(f"ring_attention_sharded: sequence lengths {S} and {T} must divide by the group's {n} ranks")
    if rows_sharded:
        q, k, v = (gather(t, 0, group) for t in (q, k, v))
    out = ring_attention(scatter(q, 1, group), scatter(k, 1, group), scatter(v, 1, group), group=group, scale=scale)
    out = gather(out, 1, group)
    return scatter(out, 0, group) if rows_sharded else out


@contextlib.contextmanager
def single_rank_group(device):
    """The default process group as this process alone, made on an
    in-process store (no address): NCCL for a CUDA device, gloo for the CPU;
    destroyed on exit."""
    init_world_of_one(torch.device(device).type)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
