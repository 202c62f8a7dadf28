"""Normalization ops (counterpart of ``vggt_qwen3_tpu/ops/norms.py``).

Computed in float32 with the weight applied in float32, then cast back to
the input dtype — HF Qwen3's RMSNorm semantics, so bf16 parity holds.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. ``weight`` broadcasts over leading axes."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (weight.float() * normed).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis (VGGT / Perceiver blocks)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)
