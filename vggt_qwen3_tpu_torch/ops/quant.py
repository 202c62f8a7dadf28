"""Weight-only W8 quantization (counterpart of ``vggt_qwen3_tpu/ops/quant.py``).

W8 is symmetric per output channel: ``s[n] = max|w[:, n]| / 127`` (then
clamped to 1e-8), ``w8 = round(w / s)`` with the f32 scale, the scale stored
as bf16. XLA compiles the division by the constant 127 to a product with
``f32(1/127)``; the quantizers here write that product, so their scales are
bit-identical to those of the JAX package's compiled quantizers
(``quantize_params`` jits them).

:func:`linear` multiplies by a dense matrix or a ``{"w8", "scale"}`` dict;
for the dict it dequantizes first, ``w8.to(x.dtype) * scale.to(x.dtype)``
(the product rounded to the activation dtype, as the JAX module's
``w8.astype(bf16) * scale`` is), then runs one matmul. That is plain XLA in
JAX, so here it is plain PyTorch on every device.

Not ported: the W4 storage mode and the W8A8 (int8 activation) marker; a
tree that holds either raises ``NotImplementedError`` (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Dict

import torch

A8_MARKER = "a8"


def inv_127(like: torch.Tensor) -> torch.Tensor:
    """``f32(1/127)`` on ``like``'s device, the factor XLA puts in place of
    ``/ 127.0``."""
    return torch.tensor(1.0 / 127.0, dtype=torch.float32, device=like.device)


def quantize_per_channel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., K, N] → {"w8": int8 [..., K, N], "scale": bf16 [..., 1, N]}.

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
    values and the scales are bit-identical to the JAX quantizer's."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(-2, keepdim=True) * inv_127(wf), 1e-8)
    w8 = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"w8": w8, "scale": s.to(torch.bfloat16)}


def require_w8(w) -> None:
    """Raise for a W4 or W8A8 dict: only plain W8 is ported."""
    if "w4p" in w:
        raise NotImplementedError("W4 weights are not ported yet (ROADMAP queue 1 item 4: W8A8/W4 modes)")
    if A8_MARKER in w:
        raise NotImplementedError("W8A8 (int8 activations) is not ported yet (ROADMAP queue 1 item 4: W8A8/W4 modes)")


def dequantize_as(w: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``w8.to(dtype) * scale.to(dtype)``: the dense matrix :func:`linear`
    multiplies by, rounded to ``dtype``."""
    require_w8(w)
    return w["w8"].to(dtype) * w["scale"].to(dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a dense tensor or a W8 ``{"w8", "scale"}`` dict (the
    stacked ``[L, K, N]`` form broadcasts over its leading axis)."""
    if not isinstance(w, dict):
        return x @ w
    return x @ dequantize_as(w, x.dtype)


def dequantize(w) -> torch.Tensor:
    """Quantized dict → dense bf16 (``w8.to(bf16) * scale``); a dense tensor
    passes through."""
    if not isinstance(w, dict):
        return w
    return dequantize_as(w, torch.bfloat16)
