"""Perceiver resampler in eval mode (counterpart of
``vggt_qwen3_tpu/models/perceiver.py``): learned latents cross-attend to the
projected vision tokens, with the reference's post-LN residual order

    latents = norm1(latents + attn(latents ⟵ context))
    latents = norm2(latents + mlp(latents))

and an exact-erf GELU MLP. Attention is plain ``mha`` (the JAX module uses
XLA there too; head dim 512 at ``perceiver_small``). Dropout belongs to
training, which waits for its slice.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config import PerceiverConfig
from ..ops.attention import mha
from ..ops.norms import layer_norm
from .qwen3 import torch_dtype

Params = Dict[str, object]


def init_params(
    gen: torch.Generator, cfg: PerceiverConfig, in_dim: int, out_dim: int, dtype: str = "float32"
) -> Params:
    """Xavier-uniform linears, zero biases, latents ~ N(0, 0.02²), on ``gen.device``."""
    dt = torch_dtype(dtype)
    dev = gen.device
    D, Fh, L, N = cfg.latent_dim, cfg.ffn_dim, cfg.num_layers, cfg.num_latents

    def xavier(shape):
        limit = (6.0 / (shape[-2] + shape[-1])) ** 0.5
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        return x.uniform_(-limit, limit, generator=gen).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    latents = torch.empty((N, D), dtype=torch.float32, device=dev).normal_(0.0, 0.02, generator=gen)
    return {
        "latents": latents.to(dt),
        "in_proj_w": xavier((in_dim, D)),
        "in_proj_b": zeros(D),
        "layers": {
            "wq": xavier((L, D, D)), "wk": xavier((L, D, D)),
            "wv": xavier((L, D, D)), "wo": xavier((L, D, D)),
            "bq": zeros(L, D), "bk": zeros(L, D), "bv": zeros(L, D), "bo": zeros(L, D),
            "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
            "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
            "mlp_w1": xavier((L, D, Fh)), "mlp_b1": zeros(L, Fh),
            "mlp_w2": xavier((L, Fh, D)), "mlp_b2": zeros(L, D),
        },
        "out_proj_w": xavier((D, out_dim)),
        "out_proj_b": zeros(out_dim),
    }


def apply(params: Params, cfg: PerceiverConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Resample ``tokens`` [B, T, in_dim] → [B, num_latents, out_dim] (eval)."""
    B = tokens.shape[0]
    D, H = cfg.latent_dim, cfg.num_heads
    hd = D // H
    context = tokens @ params["in_proj_w"] + params["in_proj_b"]
    lat = params["latents"][None].expand(B, -1, -1).to(context.dtype)
    layers = params["layers"]
    eps = cfg.layer_norm_eps
    for i in range(cfg.num_layers):
        lp = {k: w[i] for k, w in layers.items()}
        q = (lat @ lp["wq"] + lp["bq"]).reshape(B, -1, H, hd)
        k = (context @ lp["wk"] + lp["bk"]).reshape(B, -1, H, hd)
        v = (context @ lp["wv"] + lp["bv"]).reshape(B, -1, H, hd)
        attn = mha(q, k, v).reshape(B, -1, D) @ lp["wo"] + lp["bo"]
        lat = layer_norm(lat + attn, lp["ln1_w"], lp["ln1_b"], eps)
        h = F.gelu(lat @ lp["mlp_w1"] + lp["mlp_b1"]) @ lp["mlp_w2"] + lp["mlp_b2"]
        lat = layer_norm(lat + h, lp["ln2_w"], lp["ln2_b"], eps)
    return lat @ params["out_proj_w"] + params["out_proj_b"]
