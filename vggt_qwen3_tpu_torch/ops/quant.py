"""Weight quantization: W8, W8A8 and W4 (counterpart of
``vggt_qwen3_tpu/ops/quant.py``).

Schemes, as in the JAX module:

- **W8**: symmetric per output channel — ``s[n] = max|w[:, n]| / 127``
  (then clamped to 1e-8), ``w8 = round(w / s)`` with the f32 scale, the
  scale stored as bf16. :func:`linear` dequantizes, ``w8.to(x.dtype) *
  scale.to(x.dtype)`` (rounded to the activation dtype, as the JAX module's
  ``w8.astype(bf16) * scale`` is), then runs one matmul.
- **W8A8**: a W8 dict tagged by :func:`mark_act_quant`. :func:`linear`
  quantizes the activations per row (:func:`quantize_activations`), takes the
  exact int32 product of the two int8 matrices and scales it in f32:
  ``(y · xs) · scale`` in that order, then one cast to the activation dtype.
- **W4**: symmetric per (group of 128 rows along K, channel), two nibbles a
  byte in a half-split layout (low nibbles = rows ``[:K/2]``, high = rows
  ``[K/2:]``); :func:`linear` dequantizes each half to bf16 and runs two
  matmuls.

XLA compiles a division by a constant (``/ 127.0``, ``/ 7.0``) to a product
with its f32 reciprocal; the quantizers here write that product, so their
scales are bit-identical to those of the JAX package's compiled quantizers
(``quantize_params`` jits them). ``round(x / s)`` by a computed scale stays a
true division in both. ``torch.round`` rounds half to even, as ``jnp.round``
does.

All of this is plain XLA in JAX (the int8×int8 product is a ``dot_general``
with an int32 result), so here it is plain PyTorch: ``torch._int_mm`` for the
int8 product. On the card that call takes more than 16 rows and K and N
multiples of 8; :func:`int8_matmul` zero-pads the rows of a smaller product
(exact: a padded row's sums are 0 and are dropped), and a shape it still
refuses raises there.

The W8A8 int8 matrix is kept channel-major (each output channel's K values
contiguous), as a ``[..., K, N]`` view of ``[..., N, K]`` storage: on the
card cuBLASLt runs its int8 GEMM for that layout ("tn") about five times
faster than for a row-major weight ("nn"), with no copy either way (PERF.md).
The values are those of the JAX tree.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

A8_MARKER = "a8"
W4_GROUP = 128
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def inv_127(like: torch.Tensor) -> torch.Tensor:
    """``f32(1/127)`` on ``like``'s device, the factor XLA puts in place of
    ``/ 127.0``."""
    return torch.tensor(1.0 / 127.0, dtype=torch.float32, device=like.device)


def quantize_per_channel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., K, N] → {"w8": int8 [..., K, N], "scale": bf16 [..., 1, N]}."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(-2, keepdim=True) * inv_127(wf), 1e-8)
    w8 = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"w8": w8, "scale": s.to(torch.bfloat16)}


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8: [M, K] → (int8 [M, K], f32 scale [M, 1])."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1, keepdim=True) * inv_127(xf), 1e-8)
    x8 = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return x8, s


def is_plain_w8(w) -> bool:
    """A W8 dict without the W8A8 marker: what the fused W8 kernels take."""
    return isinstance(w, dict) and "w8" in w and A8_MARKER not in w


def mark_act_quant(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Tag a W8 dict so :func:`linear` runs it as int8×int8 (W8A8).

    The marker is a zero-size int8 leaf ``[..., 0]`` that keeps the stacked
    layer axes, so a per-layer view slices it like every other leaf (as in
    the JAX module). The int8 matrix comes back channel-major (see the module
    docstring); its values are unchanged."""
    w8 = w["w8"]
    marker = torch.zeros(w8.shape[:-2] + (0,), dtype=torch.int8, device=w8.device)
    return dict(w, w8=w8.transpose(-1, -2).contiguous().transpose(-1, -2), **{A8_MARKER: marker})


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``x8 [M, K] @ w8 [K, N]`` (``torch._int_mm``), the rows
    zero-padded to ``INT_MM_MIN_ROWS`` when fewer."""
    M = x8.shape[0]
    if M >= INT_MM_MIN_ROWS:
        return torch._int_mm(x8, w8)
    pad = x8.new_zeros((INT_MM_MIN_ROWS - M, x8.shape[1]))
    return torch._int_mm(torch.cat([x8, pad]), w8)[:M]


def _w8a8_linear(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    if w["w8"].ndim != 2:
        raise ValueError(
            f"W8A8 linear expects a 2-D weight, got shape {tuple(w['w8'].shape)}: stacked [L, K, N] W8A8 "
            "dicts must be sliced per layer first, unlike the plain-W8 branch which batches over leading dims")
    lead = x.shape[:-1]
    x8, xs = quantize_activations(x.reshape(-1, x.shape[-1]))
    y = int8_matmul(x8, w["w8"])
    y = y.float() * xs * w["scale"].float()
    return y.to(x.dtype).reshape(*lead, -1)


# ---------------------------------------------------------------------------
# W4 storage mode
# ---------------------------------------------------------------------------


def quantize_per_group_w4(w: torch.Tensor, *, group: int = W4_GROUP) -> Dict[str, torch.Tensor]:
    """[K, N] → {"w4p": int8 [K//2, N] packed nibbles (low = rows [:K//2],
    high = rows [K//2:]), "gscale": bf16 [K//group, N]}. The group shrinks
    to K//2 for narrow test widths, so the half-split stays legal."""
    K, N = w.shape
    group = min(group, K // 2)
    if K % 2 or K % group or (K // 2) % group:
        raise ValueError(f"W4 needs K even and K/2 a multiple of the group: K={K}, group={group}")
    wf = w.float().reshape(K // group, group, N)
    s = torch.clamp_min(wf.abs().amax(1, keepdim=True) * torch.tensor(1.0 / 7.0, device=wf.device), 1e-8)
    q = torch.clamp(torch.round(wf / s), -7, 7).to(torch.int8).reshape(K, N)
    packed = (q[: K // 2] & 0xF) | (q[K // 2:] << 4)  # int8 shifts wrap, as jnp's do
    return {"w4p": packed, "gscale": s[:, 0, :].to(torch.bfloat16)}


def quantize_stacked_w4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[L, K, N] → the stacked W4 dict, quantized one layer at a time (the
    JAX module's ``lax.map``), so the f32 working set is one matrix."""
    L = w.shape[0]
    first = quantize_per_group_w4(w[0])
    out = {k: torch.empty((L,) + v.shape, dtype=v.dtype, device=v.device) for k, v in first.items()}
    for li in range(L):
        for k, v in (first if li == 0 else quantize_per_group_w4(w[li])).items():
            out[k][li] = v
    return out


def _w4_halves(packed: torch.Tensor, gscale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed [K//2, N] + scales [K//g, N] → (bf16 [K//2, N] low-half rows,
    bf16 [K//2, N] high-half rows)."""
    K2, N = packed.shape
    g = 2 * K2 // gscale.shape[0]
    s_lo, s_hi = gscale[: K2 // g], gscale[K2 // g:]
    lo = ((packed << 4) >> 4).to(torch.bfloat16)  # int8: the low nibble sign-extended
    hi = (packed >> 4).to(torch.bfloat16)  # arithmetic shift: the signed high nibble
    lo = (lo.reshape(K2 // g, g, N) * s_lo[:, None, :]).reshape(K2, N)
    hi = (hi.reshape(K2 // g, g, N) * s_hi[:, None, :]).reshape(K2, N)
    return lo, hi


def _w4_linear(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Two matmuls over the K halves, as the JAX module runs them."""
    K2 = w["w4p"].shape[-2]
    lo, hi = _w4_halves(w["w4p"], w["gscale"])
    return x[..., :K2] @ lo.to(x.dtype) + x[..., K2:] @ hi.to(x.dtype)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a dense tensor or a quantized dict: W8 (the stacked
    ``[L, K, N]`` form broadcasts over its leading axis), W8A8 (2-D only) or
    W4 (2-D)."""
    if not isinstance(w, dict):
        return x @ w
    if "w4p" in w:
        return _w4_linear(x, w)
    if A8_MARKER in w:
        return _w8a8_linear(x, w)
    return x @ (w["w8"].to(x.dtype) * w["scale"].to(x.dtype))


def dequantize(w) -> torch.Tensor:
    """Quantized dict → dense bf16 (a W8 or W8A8 dict: ``w8.to(bf16) *
    scale``; W4: both halves); a dense tensor passes through."""
    if not isinstance(w, dict):
        return w
    if "w4p" in w:
        return torch.cat(_w4_halves(w["w4p"], w["gscale"]), dim=0)
    return w["w8"].to(torch.bfloat16) * w["scale"].to(torch.bfloat16)
