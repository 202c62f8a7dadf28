"""Plain multi-head attention with GQA (counterpart of
``vggt_qwen3_tpu/ops/attention.py``).

``mha`` is plain PyTorch (the JAX package left it to XLA): f32 scores, f32
softmax, probabilities cast to the value dtype before PV, the PV product
rounded to the value dtype (the JAX einsum's result type) and then cast to
the query dtype. It serves the Perceiver, the cache-free Qwen3 forward and
the Qwen3 cached calls that no kernel takes (a chunked prefill over a
stashed prefix, decode steps over holed masks). ``mha_quantized_kv`` is the
same over an int8 cache, the scales folded onto the scores and the
probabilities. The VGGT blocks and the Qwen3 prefill call
``ops.flash_attention.flash_attention`` directly: the JAX ``attend`` existed
to apply the TPU's size gate, and the port has none.
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


def _kv_layout(k: torch.Tensor, kv_heads_major: bool):
    """(NKV, T, the einsum subscripts of a K/V operand)."""
    if kv_heads_major:
        return k.shape[1], k.shape[2], "bktd"
    return k.shape[2], k.shape[1], "btkd"


def mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    kv_heads_major: bool = False,
) -> torch.Tensor:
    """Grouped-query attention.

    q [B, S, NH, D]; k, v [B, T, NKV, D] (or [B, NKV, T, D] with
    ``kv_heads_major``, the cache layout); mask broadcastable to
    [B, NH, S, T], True = attend. Returns [B, S, NH, D] in q's dtype."""
    B, S, NH, D = q.shape
    NKV, T, kv = _kv_layout(k, kv_heads_major)
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, S, NKV, NH // NKV, D)
    scores = torch.einsum(f"bskgd,{kv}->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~_group_mask(mask, B, NH, NKV, S, T), torch.finfo(torch.float32).min)
    probs = _softmax_f32(scores).to(v.dtype)
    out = torch.einsum(f"bkgst,{kv}->bskgd", probs.float(), v.float()).to(v.dtype)
    return out.reshape(B, S, NH, D).to(q.dtype)


def mha_quantized_kv(
    q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor, v8: torch.Tensor, vs: torch.Tensor, *,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    kv_heads_major: bool = False,
) -> torch.Tensor:
    """GQA over an int8 KV cache, the scales folded out of the K/V operands:
    ``q·(k8·ks) = (q·k8)·ks`` puts the K scale on the scores, and
    ``p·(v8·vs) = (p·vs)·v8`` the V scale on the probabilities, which are
    then cast to q's dtype.

    q [B, S, NH, D]; k8, v8 int8 [B, T, NKV, D] (or [B, NKV, T, D] with
    ``kv_heads_major``); ks, vs bf16 [B, T, NKV] (or [B, NKV, T]); mask
    broadcastable to [B, NH, S, T]. Returns [B, S, NH, D] in q's dtype."""
    B, S, NH, D = q.shape
    NKV, T, kv = _kv_layout(k8, kv_heads_major)
    if scale is None:
        scale = D ** -0.5

    def scales_bkt(s):  # [B, NKV, T] f32 whichever layout arrived
        s = s.float()
        return s if kv_heads_major else s.transpose(1, 2)

    qg = q.reshape(B, S, NKV, NH // NKV, D)
    # int8 values are exact in q's dtype; the products are summed in f32
    scores = torch.einsum(f"bskgd,{kv}->bkgst", qg.float(), k8.float())
    scores = scores * (scales_bkt(ks)[:, :, None, None, :] * scale)
    if mask is not None:
        scores = scores.masked_fill(~_group_mask(mask, B, NH, NKV, S, T), torch.finfo(torch.float32).min)
    probs = (_softmax_f32(scores) * scales_bkt(vs)[:, :, None, None, :]).to(q.dtype)
    out = torch.einsum(f"bkgst,{kv}->bskgd", probs.float(), v8.float())
    return out.reshape(B, S, NH, D).to(q.dtype)
