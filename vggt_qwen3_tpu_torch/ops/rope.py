"""Rotary position embeddings, HF rotate-half form (counterpart of
``vggt_qwen3_tpu/ops/rope.py``). Tables in float32; applied in float32 and
cast back to the activation dtype."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 of shape ``positions.shape + (head_dim,)``, the
    half-frequency table duplicated (HF layout)."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim)
    )
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, n_heads, head_dim]; cos/sin: [..., S, head_dim]."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
