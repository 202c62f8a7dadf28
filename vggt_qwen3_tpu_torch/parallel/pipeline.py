"""Pipeline parallelism for the Qwen3 decoder stack (counterpart of
``vggt_qwen3_tpu/parallel/pipeline.py``): a GPipe schedule over the mesh's
``pp`` axis.

- The stacked layers ``[L, ...]`` are stage-sharded over ``pp`` (the
  registry's ``spec_with_pp``): pp rank ``r`` holds, and runs, layers
  ``[r·L/pp, (r+1)·L/pp)``. A plain tensor every rank holds whole is cut
  into the same stages (its gradient comes back whole on every rank, as for
  JAX's replicated input).
- Each rank splits its rows into ``M`` microbatches and runs them in order:
  microbatch ``i`` enters rank 0 from the batch and every later rank from
  rank − 1, runs the stage's layers one by one under recompute, and goes on
  to rank + 1 — at tick ``t`` rank ``r`` runs microbatch ``t − r``. The
  bubble ticks compute nothing (JAX computes them on clamped inputs and
  drops the result).
- The last rank's outputs are broadcast over ``pp``, so every rank returns
  the whole ``[B, S, H]`` hidden state and the final norm, head and loss run
  replicated over ``pp``.

``torch.distributed``'s point-to-point calls carry no gradient, where JAX's
``ppermute`` has a transpose; so each hand-off is an autograd function whose
backward sends the cotangent to rank − 1, and the broadcast's backward hands
the last rank its own cotangent (every rank's is the same: the loss is
replicated) without summing it ``pp`` times. The input's cotangent, which
only rank 0 produces, is all-reduced over ``pp``, as the transpose of JAX's
replicated input sums it. A hand-off is tagged with its microbatch; every
rank's backward takes the microbatches in the reverse order, so the sends
and receives pair up on NCCL, which ignores tags, too.

Utilization is GPipe's ``M / (M + pp − 1)``; the trainer takes ``M = 2·pp``
unless ``pp_microbatches`` says otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.common import layer_views, remat
from .sharding import sum_grad


@dataclass(frozen=True)
class PipelinePlan:
    """The pp mesh and the number of microbatches per call."""

    mesh: DeviceMesh
    num_microbatches: int

    @property
    def pp(self) -> int:
        names = self.mesh.mesh_dim_names
        return self.mesh.size(names.index("pp")) if "pp" in names else 1


class _Send(torch.autograd.Function):
    """Send ``x`` to ``dst`` (non-blocking: the request joins ``works``);
    returns a scalar token that ties the send into the graph. The backward
    receives ``x``'s cotangent from ``dst``."""

    @staticmethod
    def forward(ctx, x, dst, tag, group, works):
        ctx.dst, ctx.tag, ctx.group = dst, tag, group
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        works.append(dist.isend(x.contiguous(), dst, group=group, tag=tag))
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        dist.recv(g, ctx.dst, group=ctx.group, tag=ctx.tag)
        return g, None, None, None, None


class _Recv(torch.autograd.Function):
    """Receive a ``like``-shaped tensor from ``src``; ``anchor`` (a scalar
    that requires grad) keeps the node in the graph. The backward sends the
    cotangent back to ``src``."""

    @staticmethod
    def forward(ctx, anchor, src, tag, group, like):
        ctx.src, ctx.tag, ctx.group = src, tag, group
        x = torch.empty_like(like)
        dist.recv(x, src, group=group, tag=tag)
        return x

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.src, group=ctx.group, tag=ctx.tag)
        return None, None, None, None, None


class _Collect(torch.autograd.Function):
    """Broadcast ``out`` from the last pp rank ``src``. Extra inputs (the
    pipeline's input and the send tokens) get zero cotangents, so that each
    rank's backward reaches its sends and the input's all-reduce."""

    @staticmethod
    def forward(ctx, src, group, out, *extra):
        ctx.is_src = dist.get_rank() == src
        ctx.shapes = [(e.shape, e.dtype, e.device) for e in extra]
        out = out.contiguous().clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        zeros = [torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.shapes]
        return (None, None, g if ctx.is_src else None, *zeros)


def pipeline_decoder(
    layers: Any,
    h: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    *,
    plan: PipelinePlan,
    layer_fn,
) -> torch.Tensor:
    """Run the stacked decoder layers as a ``pp``-stage GPipe pipeline.

    Args:
        layers: stacked layer params (every leaf ``[L, ...]``, ``L % pp == 0``):
            DTensors stage-sharded over ``pp``, or plain tensors.
        h: [B, S, H] hidden states of this rank's rows (``B % M == 0``).
        cos/sin: [B, S, D] rotary tables (microbatched alongside ``h``).
        mask: optional attention mask broadcastable to [B, 1, S, S].
        plan: the mesh and the microbatch count ``M``.
        layer_fn: ``(h_mb, layer_params, cos_mb, sin_mb, mask_mb) → h_mb``,
            ONE layer; its layer params may be per-layer shards, which it
            gathers itself (``parallel.sharding.full_tree``).
    Returns:
        [B, S, H] after all ``L`` layers, on every pp rank.
    """
    pp = plan.pp
    M = plan.num_microbatches
    B, S, _ = h.shape
    L = next(iter(_leaves(layers))).shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    if L % pp:
        raise ValueError(f"{L} layers not divisible by pp={pp}")
    mask_b = (torch.ones((B, 1, S, S), dtype=torch.bool, device=h.device) if mask is None
              else mask.expand(B, 1, S, S))

    if pp == 1:  # no pipeline axis: the plain layer loop
        for lp in layer_views(layers, L):
            h = remat(layer_fn, h, lp, cos, sin, mask_b)
        return h

    mesh = plan.mesh
    group = mesh.get_group("pp")
    r = mesh.get_local_rank("pp")
    prev = dist.get_global_rank(group, r - 1) if r > 0 else None
    nxt = dist.get_global_rank(group, r + 1) if r < pp - 1 else None
    last = dist.get_global_rank(group, pp - 1)
    stage = layer_views(layers, L // pp, stage=mesh)
    h = sum_grad(h, group)
    anchor = torch.zeros((), device=h.device, requires_grad=torch.is_grad_enabled())
    mb = B // M
    outs, tokens, works = [], [], []
    for i in range(M):
        rows = slice(i * mb, (i + 1) * mb)
        x = h[rows] if prev is None else _Recv.apply(anchor, prev, i, group, h[rows])
        for lp in stage:
            x = remat(layer_fn, x, lp, cos[rows], sin[rows], mask_b[rows])
        if nxt is None:
            outs.append(x)
        else:
            tokens.append(_Send.apply(x, nxt, i, group, works))
    for w in works:
        w.wait()
    out = torch.cat(outs) if nxt is None else torch.empty_like(h)
    return _Collect.apply(last, group, out, h, *tokens)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
