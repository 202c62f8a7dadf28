"""Geometry-token head (the port's own copy of ``vggt_qwen3_tpu/models/geom.py``).

37-dim features — R(9) + t(3) + K(9) + depth_hist(16) — through
``Linear(37→h) → SiLU → Linear(h→h)``; the per-view features are mean-pooled
over the views and the single embedding is broadcast to ``geom_tokens``
positions. Missing keys zero-fill.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from .common import normal, torch_dtype

Params = Dict[str, torch.Tensor]

FEATURE_SPLITS = {"R": 9, "t": 3, "K": 9, "depth_hist": 16}
FEATURE_DIM = sum(FEATURE_SPLITS.values())  # 37


def init_params(gen: torch.Generator, hidden: int, dtype: str = "float32") -> Params:
    """N(0, 0.02²) weights, zero biases, on ``gen.device``."""
    dt = torch_dtype(dtype)
    return {
        "w1": normal(gen, (FEATURE_DIM, hidden), 0.02, dt),
        "b1": torch.zeros((hidden,), dtype=dt, device=gen.device),
        "w2": normal(gen, (hidden, hidden), 0.02, dt),
        "b2": torch.zeros((hidden,), dtype=dt, device=gen.device),
    }


def pack_features(geom: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate R/t/K/depth_hist ([B, V, k] each) → [B, V, 37],
    zero-filling absent keys."""
    ref = next(v for k, v in geom.items() if k in FEATURE_SPLITS)
    parts = []
    for name, width in FEATURE_SPLITS.items():
        val = geom.get(name)
        if val is None:
            val = torch.zeros(ref.shape[:-1] + (width,), dtype=ref.dtype, device=ref.device)
        parts.append(val)
    return torch.cat(parts, dim=-1)


def apply(params: Params, geom: Optional[Mapping[str, torch.Tensor]], geom_tokens: int) -> Optional[torch.Tensor]:
    """[B, V, 37] features → [B, geom_tokens, hidden]; None when disabled.

    The features' and the weights' dtypes promote as JAX promotes them (f32
    features with bf16 weights compute in f32)."""
    if geom is None or geom_tokens == 0:
        return None
    feats = pack_features(geom)
    dt = torch.promote_types(feats.dtype, params["w1"].dtype)
    pooled = feats.to(dt).mean(dim=1)
    h = F.silu(pooled @ params["w1"].to(dt) + params["b1"].to(dt))
    h = h @ params["w2"].to(dt) + params["b2"].to(dt)
    return h[:, None, :].expand(h.shape[0], geom_tokens, h.shape[-1])
