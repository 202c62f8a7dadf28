"""Image preprocessing (counterpart of ``vggt_qwen3_tpu/ops/preprocess.py``):
``Resize(size, BICUBIC)`` of the shorter side, ``CenterCrop(size)``, then
[0, 1] CHW float32, with no normalisation (VGGT normalises inside).

The JAX package resizes with ``jax.image.resize(..., "cubic",
antialias=True)``: Keys a = −0.5, kernel widened by the downscale factor.
PyTorch's bicubic is a = −0.75 without that widening, so the resize here is
two weight matrices built as JAX's ``scale_and_translate`` builds them, then
rounded to uint8 values as PIL does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _resize_dims(h: int, w: int, size: int) -> tuple[int, int]:
    """torchvision Resize(int): shorter side → size, aspect kept."""
    if h <= w:
        return size, max(size, int(round(size * w / h)))
    return max(size, int(round(size * h / w))), size


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 weights of JAX's antialiased cubic resize."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale) - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)  # [n_in, n_out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32).T


def resize_center_crop(image_u8, size: int, device="cpu") -> torch.Tensor:
    """[H, W, 3] uint8 → [3, size, size] float32 in [0, 1] on ``device``."""
    img = torch.from_numpy(np.array(image_u8, dtype=np.uint8)).to(device)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {tuple(img.shape)}")
    h, w = img.shape[0], img.shape[1]
    nh, nw = _resize_dims(h, w, size)
    x = img.float()
    if nh != h:
        x = torch.einsum("oh,hwc->owc", torch.from_numpy(resize_weights(h, nh)).to(device), x)
    if nw != w:
        x = torch.einsum("ow,hwc->hoc", torch.from_numpy(resize_weights(w, nw)).to(device), x)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    top = int(round((nh - size) / 2.0))
    left = int(round((nw - size) / 2.0))
    x = x[top : top + size, left : left + size]
    # × f32(1/255): the product XLA compiles the JAX module's jitted ``/ 255.0`` to
    return (x * torch.tensor(1.0 / 255.0, dtype=torch.float32, device=x.device)).permute(2, 0, 1).contiguous()


def preprocess_views(images_u8: Sequence, size: int, device="cpu") -> torch.Tensor:
    """List of [H, W, 3] uint8 arrays (any sizes) → [V, 3, size, size]."""
    return torch.stack([resize_center_crop(im, size, device) for im in images_u8], dim=0)
