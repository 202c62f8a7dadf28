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
                           scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over full (replicated) tensors, as the JAX module's
    ``shard_map`` wrapper: this rank takes its chunk of the sequence
    (``S`` and ``T`` must divide by the group's size), runs
    :func:`ring_attention` and all-gathers the output shards → ``[B, S, NH,
    D]`` on every rank.

    Forward only: gradients through the all-gather over replicated inputs
    (JAX sums the shards' cotangents) come with the mesh (ROADMAP item 6);
    with an input that requires grad this raises. Differentiate
    :func:`ring_attention` over local shards instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("ring_attention_sharded is forward-only; gradients through it over replicated "
                                  "inputs come with the mesh (ROADMAP item 6): differentiate ring_attention")
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    S, T = q.shape[1], k.shape[1]
    if S % n or T % n:
        raise ValueError(f"ring_attention_sharded: sequence lengths {S} and {T} must divide by the group's {n} ranks")
    s, t = S // n, T // n
    out = ring_attention(q[:, r * s:(r + 1) * s], k[:, r * t:(r + 1) * t], v[:, r * t:(r + 1) * t],
                         group=group, scale=scale)
    if n == 1:
        return out
    shards = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(shards, out.contiguous(), group=group)
    return torch.cat(shards, dim=1)


@contextlib.contextmanager
def single_rank_group(device):
    """The default process group as this process alone, made on an
    in-process store (no address): NCCL for a CUDA device, gloo for the CPU;
    destroyed on exit."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
