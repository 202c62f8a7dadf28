"""Plain multi-head attention with GQA (counterpart of
``vggt_qwen3_tpu/ops/attention.py``).

``mha`` is plain PyTorch (the JAX package left it to XLA): f32 scores, f32
softmax, probabilities cast to the value dtype before PV. It serves the
Perceiver and the cache-free Qwen3 forward. The VGGT blocks and the Qwen3
prefill call ``ops.flash_attention.flash_attention`` directly: the JAX
``attend`` existed to apply the TPU's size gate, and the port has none.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_causal_mask(q_len: int, kv_len: int, *, q_offset: int = 0, device=None) -> torch.Tensor:
    """Boolean [q_len, kv_len], True = may attend; ``q_offset`` shifts queries."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND together optional boolean masks (broadcasting)."""
    present = [m for m in masks if m is not None]
    if not present:
        return None
    out = present[0]
    for m in present[1:]:
        out = out & m
    return out


def _group_mask(mask: torch.Tensor, B: int, NH: int, NKV: int, S: int, T: int) -> torch.Tensor:
    """[B, NH|1, S, T] mask → broadcastable to the [B, NKV, G, S, T] scores."""
    if mask.ndim == 4 and mask.shape[1] == NH and NH > 1:
        return mask.reshape(B, NKV, NH // NKV, S, T)
    return mask[:, None] if mask.ndim == 4 else mask


def _softmax_f32(scores: torch.Tensor) -> torch.Tensor:
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    return probs / probs.sum(-1, keepdim=True)


def mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention.

    q [B, S, NH, D]; k, v [B, T, NKV, D]; mask broadcastable to
    [B, NH, S, T], True = attend. Returns [B, S, NH, D] in q's dtype."""
    B, S, NH, D = q.shape
    T, NKV = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, S, NKV, NH // NKV, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~_group_mask(mask, B, NH, NKV, S, T), torch.finfo(torch.float32).min)
    probs = _softmax_f32(scores).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float())
    return out.reshape(B, S, NH, D).to(q.dtype)
