"""Perceiver resampler (counterpart of ``vggt_qwen3_tpu/models/perceiver.py``):
learned latents cross-attend to the projected vision tokens, with the
reference's post-LN residual order

    latents = norm1(latents + attn(latents ⟵ context))
    latents = norm2(latents + mlp(latents))

and an exact-erf GELU MLP. Attention is plain ``mha`` (the JAX module uses
XLA there too; head dim 512 at ``perceiver_small``).

Training dropout (rate ``cfg.dropout``) at the three sites of each layer —
the attention output, the GELU output and the MLP output — draws its masks
from an explicit ``torch.Generator``: ``generator=None`` is eval mode. The
masks are other bits than JAX's ``jax.random`` draws from the same seed;
their distribution is the same (keep with probability ``1 − rate``, kept
values scaled by ``1/(1 − rate)``). The Perceiver is not recomputed under
``torch.utils.checkpoint`` (nor is it checkpointed in JAX): a recompute
restores the global RNG, not an explicit generator, so it would draw other
masks.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..config import PerceiverConfig
from ..ops.attention import mha
from ..ops.norms import layer_norm
from .common import layer_views, torch_dtype

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


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 − rate`` and
    scaled by ``1/(1 − rate)``, the mask drawn from ``generator`` on its
    device; ``x`` itself when ``generator`` is None or ``rate`` is 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x)).to(x.dtype)


def apply(params: Params, cfg: PerceiverConfig, tokens: torch.Tensor, *,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Resample ``tokens`` [B, T, in_dim] → [B, num_latents, out_dim].

    ``generator`` enables dropout (rate ``cfg.dropout``) for training; the
    masks are drawn from it on its device, layer by layer, in site order."""
    B = tokens.shape[0]
    D, H = cfg.latent_dim, cfg.num_heads
    hd = D // H

    def drop(x):
        return dropout(x, cfg.dropout, generator)

    context = tokens @ params["in_proj_w"] + params["in_proj_b"]
    lat = params["latents"][None].expand(B, -1, -1).to(context.dtype)
    eps = cfg.layer_norm_eps
    for lp in layer_views(params["layers"], cfg.num_layers):
        q = (lat @ lp["wq"] + lp["bq"]).reshape(B, -1, H, hd)
        k = (context @ lp["wk"] + lp["bk"]).reshape(B, -1, H, hd)
        v = (context @ lp["wv"] + lp["bv"]).reshape(B, -1, H, hd)
        attn = mha(q, k, v).reshape(B, -1, D) @ lp["wo"] + lp["bo"]
        lat = layer_norm(lat + drop(attn), lp["ln1_w"], lp["ln1_b"], eps)
        h = drop(F.gelu(lat @ lp["mlp_w1"] + lp["mlp_b1"])) @ lp["mlp_w2"] + lp["mlp_b2"]
        lat = layer_norm(lat + drop(h), lp["ln2_w"], lp["ln2_b"], eps)
    return lat @ params["out_proj_w"] + params["out_proj_b"]
