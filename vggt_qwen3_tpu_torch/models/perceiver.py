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
values scaled by ``1/(1 − rate)``). Under data parallelism each rank holds
some rows of the batch: ``batch_rows`` makes it draw every mask at the
global batch's shape and keep its own rows, so a run over several ranks
draws the masks a run in one process draws (as JAX's sharding-invariant
``jax.random`` does). The Perceiver is not recomputed under
``torch.utils.checkpoint`` (nor is it checkpointed in JAX): a recompute
restores the global RNG, not an explicit generator, so it would draw other
masks.

:func:`convert_torch_state_dict` maps the reference ``PerceiverProjector``'s
state dict into this layout, as the JAX module's converter does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..config import PerceiverConfig
from ..ops.attention import mha
from ..ops.norms import layer_norm
from ..parallel.sharding import full_tree
from .common import as_f32, layer_views, leaf, made, torch_dtype

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
        return made(x.uniform_(-limit, limit, generator=gen).to(dt))

    def zeros(*shape):
        return made(torch.zeros(shape, dtype=dt, device=dev))

    def ones(*shape):
        return made(torch.ones(shape, dtype=dt, device=dev))

    latents = torch.empty((N, D), dtype=torch.float32, device=dev).normal_(0.0, 0.02, generator=gen)
    return {
        "latents": made(latents.to(dt)),
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


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            batch_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 − rate`` and
    scaled by ``1/(1 − rate)``, the mask drawn from ``generator`` on its
    device; ``x`` itself when ``generator`` is None or ``rate`` is 0.
    ``batch_rows = (first, total)``: ``x`` holds rows ``first …`` of a batch
    of ``total``; the mask is drawn for all ``total`` and these rows kept."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if batch_rows is None:
        mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    else:
        first, total = batch_rows
        mask = torch.rand((total,) + x.shape[1:], generator=generator, device=generator.device) < keep
        mask = mask[first:first + x.shape[0]]
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x)).to(x.dtype)


def apply(params: Params, cfg: PerceiverConfig, tokens: torch.Tensor, *,
          generator: Optional[torch.Generator] = None,
          batch_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Resample ``tokens`` [B, T, in_dim] → [B, num_latents, out_dim].

    ``generator`` enables dropout (rate ``cfg.dropout``) for training; the
    masks are drawn from it on its device, layer by layer, in site order
    (at the global batch's shape with ``batch_rows``: :func:`dropout`).
    Sharded parameters are gathered whole."""
    params = full_tree(params)
    B = tokens.shape[0]
    D, H = cfg.latent_dim, cfg.num_heads
    hd = D // H

    def drop(x):
        return dropout(x, cfg.dropout, generator, batch_rows)

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


def convert_torch_state_dict(sd, cfg: PerceiverConfig, dtype: str = "float32", device="cuda") -> Params:
    """A reference ``PerceiverProjector.state_dict()`` → this layout, on
    ``device``. ``nn.MultiheadAttention`` packs Q, K and V as
    ``in_proj_weight`` [3D, D]: split and transposed into [D, D] matrices;
    every linear is transposed to [in, out]. Leaves go through float32 and
    are cast to ``dtype``."""
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    D, L = cfg.latent_dim, cfg.num_layers
    stacked = {k: [] for k in (
        "wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",
        "ln1_w", "ln1_b", "ln2_w", "ln2_b", "mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2",
    )}
    for i in range(L):
        p = f"layers.{i}"
        w = as_f32(sd[f"{p}.self_attn.in_proj_weight"])  # [3D, D]
        b = as_f32(sd[f"{p}.self_attn.in_proj_bias"])
        for j, n in enumerate("qkv"):
            stacked[f"w{n}"].append(w[j * D:(j + 1) * D].T)
            stacked[f"b{n}"].append(b[j * D:(j + 1) * D])
        stacked["wo"].append(as_f32(sd[f"{p}.self_attn.out_proj.weight"]).T)
        stacked["bo"].append(as_f32(sd[f"{p}.self_attn.out_proj.bias"]))
        for ours, theirs in (("ln1", "norm1"), ("ln2", "norm2")):
            stacked[f"{ours}_w"].append(as_f32(sd[f"{p}.{theirs}.weight"]))
            stacked[f"{ours}_b"].append(as_f32(sd[f"{p}.{theirs}.bias"]))
        for ours, theirs in (("mlp_w1", "mlp.0.weight"), ("mlp_w2", "mlp.3.weight")):
            stacked[ours].append(as_f32(sd[f"{p}.{theirs}"]).T)
        stacked["mlp_b1"].append(as_f32(sd[f"{p}.mlp.0.bias"]))
        stacked["mlp_b2"].append(as_f32(sd[f"{p}.mlp.3.bias"]))
    return {
        "latents": leaf(as_f32(sd["latents"]), dt, device),
        "in_proj_w": leaf(as_f32(sd["in_proj.weight"]).T, dt, device),
        "in_proj_b": leaf(as_f32(sd["in_proj.bias"]), dt, device),
        "layers": {k: leaf(torch.stack(v), dt, device) for k, v in stacked.items()},
        "out_proj_w": leaf(as_f32(sd["out_proj.weight"]).T, dt, device),
        "out_proj_b": leaf(as_f32(sd["out_proj.bias"]), dt, device),
    }
