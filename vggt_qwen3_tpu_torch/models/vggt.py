"""VGGT-1B aggregator in PyTorch (counterpart of
``vggt_qwen3_tpu/models/vggt.py``).

``aggregator(params, cfg, images)`` with images [B, S, 3, H, W] in [0, 1]:
ImageNet normalisation in float32, a DINOv2 ViT-L/14 patch backbone (patch
embed as reshape + matmul, pos-embed bicubically resized with torch's a=−0.75
kernel when H ≠ 518), per-frame camera and register tokens (separate
embeddings for the first frame), then ``num_layers`` pairs of frame-wise
([B·S, T, E]) and global ([B, S·T, E]) blocks with 2-D RoPE on the patch
tokens (1-based coordinates, specials at (0, 0)). The last pair's frame and
global outputs are concatenated → [B, S, T, 2E].

Every block's attention is ``ops.flash_attention.flash_attention``: the
flash kernel on the card (D = 64 at VGGT-1B), its plain version on the CPU.

Training (grad enabled, the tower not frozen): each DINOv2 block and each
frame/global pair runs under ``torch.utils.checkpoint`` (non-reentrant), the
boundaries of ``jax.checkpoint`` in the JAX module, so the backward keeps one
[B·S, T, E] input per block and recomputes the block's forward — the 72
attentions run twice a micro step, and their backward (flash kernels 8 and 9)
once. Without recompute the activations of the 72 blocks at B = 2, 8 views,
448² would take about 40 GB.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import VGGTConfig
from ..ops.flash_attention import flash_attention
from ..ops.norms import layer_norm
from ..ops.rope2d import apply_rope2d, rope2d_cos_sin
from .common import layer_views, normal, remat, torch_dtype

Params = Dict[str, object]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _init_block_stack(gen, L, E, mlp_ratio, ls_init, dt):
    Fh = int(E * mlp_ratio)
    dev = gen.device

    def full(shape, val):
        return torch.full(shape, val, dtype=dt, device=dev)

    return {
        "ln1_w": full((L, E), 1.0),
        "ln1_b": full((L, E), 0.0),
        "qkv_w": normal(gen, (L, E, 3 * E), 0.02, dt),
        "qkv_b": full((L, 3 * E), 0.0),
        "proj_w": normal(gen, (L, E, E), 0.02, dt),
        "proj_b": full((L, E), 0.0),
        "ls1": full((L, E), ls_init),
        "ln2_w": full((L, E), 1.0),
        "ln2_b": full((L, E), 0.0),
        "mlp_w1": normal(gen, (L, E, Fh), 0.02, dt),
        "mlp_b1": full((L, Fh), 0.0),
        "mlp_w2": normal(gen, (L, Fh, E), 0.02, dt),
        "mlp_b2": full((L, E), 0.0),
        "ls2": full((L, E), ls_init),
    }


def init_params(gen: torch.Generator, cfg: VGGTConfig, dtype: Optional[str] = None) -> Params:
    """Random init on ``gen.device`` with the JAX module's shapes."""
    dt = torch_dtype(dtype or cfg.dtype)
    E, R, P = cfg.embed_dim, cfg.num_register_tokens, cfg.patch_size
    n_side = cfg.img_size // P
    return {
        "patch": {
            "proj_w": normal(gen, (P, P, 3, E), 0.02, dt),
            "proj_b": torch.zeros((E,), dtype=dt, device=gen.device),
            "cls": normal(gen, (E,), 0.02, dt),
            "reg": normal(gen, (R, E), 0.02, dt),
            "pos": normal(gen, (1 + n_side * n_side, E), 0.02, dt),
            "blocks": _init_block_stack(gen, cfg.patch_depth, E, cfg.mlp_ratio, cfg.patch_ls_init, dt),
            "norm_w": torch.ones((E,), dtype=dt, device=gen.device),
            "norm_b": torch.zeros((E,), dtype=dt, device=gen.device),
        },
        "camera_token": normal(gen, (2, 1, E), 0.02, dt),
        "register_token": normal(gen, (2, R, E), 0.02, dt),
        "frame_blocks": _init_block_stack(gen, cfg.num_layers, E, cfg.mlp_ratio, cfg.agg_ls_init, dt),
        "global_blocks": _init_block_stack(gen, cfg.num_layers, E, cfg.mlp_ratio, cfg.agg_ls_init, dt),
    }


def _vit_block(x, bp, num_heads, eps, *, cos=None, sin=None, rot_mask=None):
    """Pre-LN ViT block with LayerScale; optional 2-D rope on q/k."""
    B, T, E = x.shape
    hd = E // num_heads
    h = layer_norm(x, bp["ln1_w"], bp["ln1_b"], eps)
    qkv = h @ bp["qkv_w"] + bp["qkv_b"]
    q, k, v = (t.reshape(B, T, num_heads, hd) for t in qkv.chunk(3, dim=-1))
    if cos is not None:
        q = apply_rope2d(q, cos, sin, rot_mask)
        k = apply_rope2d(k, cos, sin, rot_mask)
    attn = flash_attention(q, k, v).reshape(B, T, E)
    x = x + bp["ls1"] * (attn @ bp["proj_w"] + bp["proj_b"])
    h = layer_norm(x, bp["ln2_w"], bp["ln2_b"], eps)
    h = F.gelu(h @ bp["mlp_w1"] + bp["mlp_b1"])  # exact erf GELU
    return x + bp["ls2"] * (h @ bp["mlp_w2"] + bp["mlp_b2"])


def _pair(x, fbp, gbp, B, S, T, E, num_heads, eps, cos_frame, sin_frame, cos_global, sin_global):
    """One frame block then one global block: (new x, the frame output)."""
    x = _vit_block(x, fbp, num_heads, eps, cos=cos_frame, sin=sin_frame)
    xg = _vit_block(x.reshape(B, S * T, E), gbp, num_heads, eps, cos=cos_global, sin=sin_global)
    return xg.reshape(B * S, T, E), x


def _torch_bicubic_weights(n_in: int, n_out: int, scale: Optional[float]) -> np.ndarray:
    """Row-resize weights [n_out, n_in] of torch ``F.interpolate(mode=
    "bicubic", align_corners=False, antialias=False)``: a = −0.75, half-pixel
    centres, edge-clamped taps; ``scale`` given → scale_factor mode (DINOv2
    passes ``(w0 + interpolate_offset) / M``), None → size mode. Built in
    numpy so the weights are the JAX module's to the bit."""
    a = -0.75

    def kernel(t):
        t = abs(t)
        if t <= 1.0:
            return (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0
        if t < 2.0:
            return a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a
        return 0.0

    W = np.zeros((n_out, n_in), np.float64)
    inv_scale = (n_in / n_out) if scale is None else (1.0 / scale)
    for i in range(n_out):
        src = (i + 0.5) * inv_scale - 0.5
        base = int(np.floor(src))
        t = src - base
        for off in (-1, 0, 1, 2):
            j = min(max(base + off, 0), n_in - 1)
            W[i, j] += kernel(off - t)
    return W.astype(np.float32)


def _torch_bicubic_resize(grid: torch.Tensor, hw: Tuple[int, int], offset: float) -> torch.Tensor:
    """[M1, M2, D] → [h, w, D] float32 through two weight matrices."""
    M1, M2, _ = grid.shape
    h, w = hw
    sy = (h + offset) / M1 if offset else None
    sx = (w + offset) / M2 if offset else None
    Wy = torch.from_numpy(_torch_bicubic_weights(M1, h, sy)).to(grid.device)
    Wx = torch.from_numpy(_torch_bicubic_weights(M2, w, sx)).to(grid.device)
    g = torch.einsum("hm,mnd->hnd", Wy, grid.float())
    return torch.einsum("wn,hnd->hwd", Wx, g)


def _patch_backbone(params: Params, cfg: VGGTConfig, frames: torch.Tensor) -> torch.Tensor:
    """DINOv2-style backbone: frames [N, 3, H, W] → patch tokens [N, P², E]."""
    pp = params["patch"]
    N, _, H, W = frames.shape
    P = cfg.patch_size
    hp, wp = H // P, W // P
    # patch embed as reshape + matmul (no convolution, so no cuDNN TF32)
    x = frames.reshape(N, 3, hp, P, wp, P).permute(0, 2, 4, 3, 5, 1).reshape(N, hp * wp, P * P * 3)
    x = x @ pp["proj_w"].reshape(P * P * 3, -1) + pp["proj_b"]

    pos = pp["pos"]
    n_side = cfg.img_size // P
    cls_pos, grid_pos = pos[:1], pos[1:]
    if (hp, wp) != (n_side, n_side):
        grid = _torch_bicubic_resize(grid_pos.reshape(n_side, n_side, -1), (hp, wp), cfg.interpolate_offset)
        grid_pos = grid.reshape(hp * wp, -1).to(pos.dtype)
    x = x + grid_pos[None]

    E = x.shape[-1]
    cls = (pp["cls"] + cls_pos[0]).to(x.dtype).expand(N, 1, E)
    reg = pp["reg"].to(x.dtype)[None].expand(N, -1, -1)
    x = torch.cat([cls, reg, x], dim=1)
    for bp in layer_views(pp["blocks"], cfg.patch_depth):
        x = remat(_vit_block, x, bp, cfg.num_heads, cfg.layer_norm_eps)
    x = layer_norm(x, pp["norm_w"], pp["norm_b"], cfg.layer_norm_eps)
    return x[:, 1 + cfg.num_register_tokens :]


def aggregator(params: Params, cfg: VGGTConfig, images: torch.Tensor) -> Tuple[List[torch.Tensor], int]:
    """VGGT aggregator forward.

    Args:
        images: [B, S, 3, H, W], values in [0, 1].
    Returns:
        ([last pair's concat output [B, S, T, 2E]], patch_start_idx)
    """
    B, S, C, H, W = images.shape
    dev = images.device
    dt = params["camera_token"].dtype
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev).reshape(1, 1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev).reshape(1, 1, 3, 1, 1)
    frames = ((images.float() - mean) / std).to(dt).reshape(B * S, C, H, W)

    patches = _patch_backbone(params, cfg, frames)
    Np = patches.shape[1]
    E, R, psi = cfg.embed_dim, cfg.num_register_tokens, cfg.patch_start_idx

    token_idx = (torch.arange(S, device=dev) != 0).long()  # frame 0 → 0, rest → 1
    cam = params["camera_token"][token_idx][None].expand(B, S, 1, E).reshape(B * S, 1, E)
    reg = params["register_token"][token_idx][None].expand(B, S, R, E).reshape(B * S, R, E)
    x = torch.cat([cam.to(dt), reg.to(dt), patches], dim=1)
    T = psi + Np

    hp, wp = H // cfg.patch_size, W // cfg.patch_size
    ys = torch.arange(hp, device=dev).repeat_interleave(wp) + 1
    xs = torch.arange(wp, device=dev).repeat(hp) + 1
    coords = torch.cat([torch.zeros((psi, 2), dtype=torch.long, device=dev),
                        torch.stack([ys, xs], dim=-1)], dim=0)  # [T, 2]
    cos_f, sin_f = rope2d_cos_sin(coords[None], E // cfg.num_heads, cfg.rope_freq)
    cos_frame, sin_frame = cos_f.expand(B * S, -1, -1), sin_f.expand(B * S, -1, -1)
    cos_global = cos_f.repeat(1, S, 1).expand(B, -1, -1)
    sin_global = sin_f.repeat(1, S, 1).expand(B, -1, -1)

    eps = cfg.layer_norm_eps
    fb = layer_views(params["frame_blocks"], cfg.num_layers)
    gb = layer_views(params["global_blocks"], cfg.num_layers)
    for fbp, gbp in zip(fb, gb):
        x, frame_out = remat(_pair, x, fbp, gbp, B, S, T, E, cfg.num_heads, eps, cos_frame, sin_frame,
                              cos_global, sin_global)
    concat = torch.cat([frame_out, x], dim=-1)
    return [concat.reshape(B, S, T, 2 * E)], psi
