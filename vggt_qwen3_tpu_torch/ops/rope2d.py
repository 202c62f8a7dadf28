"""2-D axial rotary embeddings for VGGT attention (counterpart of
``vggt_qwen3_tpu/ops/rope2d.py``): croco ``RoPE2D`` with frequency 100, the
head dim split in halves rotated by the patch row and column coordinate,
rotate-half pairing within each half."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope2d_cos_sin(
    coords: torch.Tensor, head_dim: int, freq: float = 100.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords [..., T, 2] (y, x) → (cos, sin) [..., T, head_dim // 2]: first
    quarter y-axis angles, second quarter x-axis angles."""
    if head_dim % 4:
        raise ValueError(f"head_dim must be divisible by 4, got {head_dim}")
    quarter = head_dim // 4
    inv = 1.0 / (
        freq ** (torch.arange(quarter, dtype=torch.float32, device=coords.device) * 2.0 / (2 * quarter))
    )
    y = coords[..., 0:1].float() * inv
    x = coords[..., 1:2].float() * inv
    ang = torch.cat([y, x], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope2d(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    rot_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x [B, T, H, D]; cos/sin [B, T, D // 2]; rot_mask [B, T] bool or None
    (False rows pass through; None when specials sit at angle 0)."""
    xf = x.float()
    q = xf.shape[-1] // 4
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    cy, cx = c[..., :q], c[..., q:]
    sy, sx = s[..., :q], s[..., q:]
    cos_full = torch.cat([cy, cy, cx, cx], dim=-1)
    sin_full = torch.cat([sy, sy, sx, sx], dim=-1)
    y1, y2 = xf[..., :q], xf[..., q : 2 * q]
    x1, x2 = xf[..., 2 * q : 3 * q], xf[..., 3 * q :]
    half = torch.cat([-y2, y1, -x2, x1], dim=-1)
    rot = xf * cos_full + half * sin_full
    if rot_mask is not None:
        rot = torch.where(rot_mask[:, :, None, None], rot, xf)
    return rot.to(x.dtype)
