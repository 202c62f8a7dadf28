"""Qwen3 dense decoder in PyTorch (counterpart of
``vggt_qwen3_tpu/models/qwen3.py``).

Same parameter tree as the JAX module: per-layer weights stacked along a
leading layer axis (``params["layers"]["wq"]`` is ``[L, H, NH·D]``), the
head-major KV cache ``[L, B, NKV, T, D]`` (bf16, or int8 with bf16
per-(token, head) scales). Cache slots are sequence indices; rotary
positions are passed separately (HF position-id semantics).

Attention on the cached paths:
- prefill (``prefill_padding`` declared, offset 0): the flash-attention
  kernel over the fresh K/V of the prompt, causal with per-row bounds;
- decode (``decode_frontier``, S = 1): the GQA decode-attention kernel over
  the whole stacked cache at layer ``li``;
- any other cached call (chunked prefill, multi-token verify) raises
  ``NotImplementedError``: it belongs to the serving slice.

The cache is updated **in place** (the JAX module returns an updated copy);
``forward_hidden`` returns the same dict it was given.

Not ported in this slice: LoRA, W8/W4 weights and their fused kernels, the
fused head-argmax, per-row cache offsets (serving) and the pipeline.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Qwen3Config
from ..ops.attention import combine_masks, make_causal_mask, mha
from ..ops.decode_attention import gqa_decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin

Params = Dict[str, object]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """Config dtype string (or torch dtype) → torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def normal(gen: torch.Generator, shape, std: float, dt: torch.dtype) -> torch.Tensor:
    """N(0, std²) drawn in float32 from ``gen`` on its device, cast to ``dt``."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return x.normal_(0.0, std, generator=gen).to(dt)


def init_params(gen: torch.Generator, cfg: Qwen3Config, dtype: Optional[str] = None) -> Params:
    """Random init on ``gen.device`` (normal(0.02) linears/embeddings, unit
    norms), the JAX module's shapes and distributions."""
    dt = torch_dtype(dtype or cfg.dtype)
    dev = gen.device
    L, H, Fi = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    D, NH, NKV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    params: Params = {
        "embed": normal(gen, (cfg.vocab_size, H), 0.02, dt),
        "final_norm": ones(H),
        "layers": {
            "ln1": ones(L, H),
            "ln2": ones(L, H),
            "wq": normal(gen, (L, H, NH * D), 0.02, dt),
            "wk": normal(gen, (L, H, NKV * D), 0.02, dt),
            "wv": normal(gen, (L, H, NKV * D), 0.02, dt),
            "wo": normal(gen, (L, NH * D, H), 0.02, dt),
            "q_norm": ones(L, D),
            "k_norm": ones(L, D),
            "gate": normal(gen, (L, H, Fi), 0.02, dt),
            "up": normal(gen, (L, H, Fi), 0.02, dt),
            "down": normal(gen, (L, Fi, H), 0.02, dt),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal(gen, (H, cfg.vocab_size), 0.02, dt)
    return params


def init_cache(
    cfg: Qwen3Config, batch: int, max_len: int, dtype: Optional[str] = None, device="cpu"
) -> Dict[str, torch.Tensor]:
    """Zeroed head-major cache: k/v [L, B, NKV, max_len, D]; ``dtype='int8'``
    adds bf16 scales ks/vs [L, B, NKV, max_len]."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if (dtype or cfg.dtype) == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "vs": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        }
    dt = torch_dtype(dtype or cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, K, D] → (int8 values, bf16 per-(token, head) scales [B, S, K]).
    Quantised with the f32 scale, which is then stored as bf16;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids.long()]


def _layer(lp: Params, li: int) -> Dict[str, torch.Tensor]:
    return {k: w[li] for k, w in lp.items()}


def _layer_qkv(cfg: Qwen3Config, h, lp, cos, sin):
    """Pre-attention projections: normed x, rotated q/k, v."""
    B, S, _ = h.shape
    D, NH, NKV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    x = rms_norm(h, lp["ln1"], cfg.rms_norm_eps)
    q = (x @ lp["wq"]).reshape(B, S, NH, D)
    k = (x @ lp["wk"]).reshape(B, S, NKV, D)
    v = (x @ lp["wv"]).reshape(B, S, NKV, D)
    q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
    k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _layer_post_attn(cfg: Qwen3Config, h, lp, attn):
    B, S, _ = h.shape
    h = h + attn.reshape(B, S, cfg.num_heads * cfg.head_dim) @ lp["wo"]
    x = rms_norm(h, lp["ln2"], cfg.rms_norm_eps)
    return h + (F.silu(x @ lp["gate"]) * (x @ lp["up"])) @ lp["down"]


def forward_hidden(
    params: Params,
    cfg: Qwen3Config,
    inputs_embeds: torch.Tensor,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_offset: int = 0,
    prefill_padding: Optional[str] = None,
    decode_frontier: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run the decoder stack.

    Args:
        inputs_embeds: [B, S, H].
        attention_mask: [B, T] over key positions (T = cache length with a
            cache, else S); 1 = valid. None = all valid.
        positions: [B, S] rotary positions (default ``cache_offset + arange(S)``).
        cache: optional cache from :func:`init_cache`, written in place.
        cache_offset: slot where this segment's K/V are written (an int).
        prefill_padding: declares the prompt's valid slots one contiguous run
            per row (requires ``cache_offset == 0``) — the flash prefill.
        decode_frontier: declares each mask row one contiguous ``[start,
            end)`` run that already encodes causality — with S = 1, the
            decode-attention kernel.
    Returns:
        (hidden [B, S, H] after the final norm, the cache or None)
    """
    if isinstance(cache_offset, torch.Tensor) and cache_offset.ndim == 1:
        raise NotImplementedError(
            "per-row cache offsets belong to the serving slice (ROADMAP: serving extras)"
        )
    cache_offset = int(cache_offset)
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        positions = (cache_offset + torch.arange(S, device=dev))[None, :].expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    layers = params["layers"]
    L = cfg.num_layers
    h = inputs_embeds

    if cache is None:  # causal x key padding, plain mha
        pad = attention_mask[:, None, None, :].bool() if attention_mask is not None else None
        mask = combine_masks(make_causal_mask(S, S, q_offset=cache_offset, device=dev)[None, None], pad)
        for li in range(L):
            lp = _layer(layers, li)
            q, k, v = _layer_qkv(cfg, h, lp, cos, sin)
            h = _layer_post_attn(cfg, h, lp, mha(q, k, v, mask=mask))
        return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), None

    use_flash = prefill_padding is not None
    use_decode = decode_frontier and S == 1 and attention_mask is not None and attention_mask.ndim == 2
    if not (use_flash or use_decode):
        raise NotImplementedError(
            "a cached call is a prefill (prefill_padding) or a one-token decode step "
            "(decode_frontier with a [B, T] mask); other cached calls belong to the "
            "serving slice (ROADMAP: serving extras)"
        )
    if use_flash:
        if cache_offset != 0:
            raise ValueError("prefill_padding requires cache_offset == 0")
        prompt_mask = (attention_mask[:, :S].int() if attention_mask is not None
                       else torch.ones((B, S), dtype=torch.int32, device=dev))
        kv_start = torch.argmax(prompt_mask, dim=-1).int()
        kv_end = kv_start + prompt_mask.sum(-1).int()
    else:
        am = attention_mask.int()
        f_start = torch.argmax(am, dim=-1).int()
        # causal clamp: a sloppier caller's mask must not see the future
        f_end = torch.clamp_max(f_start + am.sum(-1).int(), cache_offset + 1)
    quantized = "ks" in cache
    sl = slice(cache_offset, cache_offset + S)

    for li in range(L):
        lp = _layer(layers, li)
        q, k, v = _layer_qkv(cfg, h, lp, cos, sin)
        if quantized:
            k8, ks = _quantize_kv(k)
            v8, vs = _quantize_kv(v)
            cache["k"][li, :, :, sl] = k8.transpose(1, 2)
            cache["v"][li, :, :, sl] = v8.transpose(1, 2)
            cache["ks"][li, :, :, sl] = ks.transpose(1, 2)
            cache["vs"][li, :, :, sl] = vs.transpose(1, 2)
        else:
            cache["k"][li, :, :, sl] = k.transpose(1, 2).to(cache["k"].dtype)
            cache["v"][li, :, :, sl] = v.transpose(1, 2).to(cache["v"].dtype)
        if use_flash:
            attn = flash_attention(q, k, v, causal=True, kv_start=kv_start, kv_end=kv_end)
        else:
            attn = gqa_decode_attention(
                q[:, 0], cache["k"], cache["v"], li, f_start, f_end,
                cache.get("ks"), cache.get("vs"),
            )[:, None]
        h = _layer_post_attn(cfg, h, lp, attn)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache


def lm_logits(params: Params, cfg: Qwen3Config, hidden: torch.Tensor) -> torch.Tensor:
    """LM head; float32 logits (the JAX einsum asks for an f32 result).

    On the card a bf16 GEMM accumulates and writes f32, reading the head in
    its own dtype. The CPU has no such call, so there the product runs on
    f32 copies: the same exact products of bf16 values and f32 sums."""
    w = params["embed"].t() if cfg.tie_word_embeddings else params["lm_head"]
    x = hidden.reshape(-1, hidden.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        out = torch.mm(x, w, out_dtype=torch.float32)
    else:
        out = x.float() @ w.float()
    return out.reshape(*hidden.shape[:-1], w.shape[-1])


def forward(
    params: Params,
    cfg: Qwen3Config,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_offset: int = 0,
    prefill_padding: Optional[str] = None,
    decode_frontier: bool = False,
    last_logit_only: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full forward → (float32 logits [B, S, V] — [B, 1, V] with
    ``last_logit_only`` — , the cache)."""
    if inputs_embeds is None:
        if input_ids is None:
            raise ValueError("forward needs input_ids or inputs_embeds")
        inputs_embeds = embed_tokens(params, input_ids)
    hidden, cache = forward_hidden(
        params, cfg, inputs_embeds,
        attention_mask=attention_mask, positions=positions, cache=cache,
        cache_offset=cache_offset, prefill_padding=prefill_padding,
        decode_frontier=decode_frontier,
    )
    if last_logit_only:
        hidden = hidden[:, -1:]
    return lm_logits(params, cfg, hidden), cache
