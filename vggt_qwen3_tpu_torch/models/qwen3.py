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
- decode (``decode_frontier``, S = 1, a [B, T] mask): the GQA
  decode-attention kernel over the whole stacked cache at layer ``li``;
- speculative block verify (``decode_frontier``, [B] offsets, S > 1, a
  [B, S, T] per-query mask): the block-verify kernel, query j seeing its
  row's frontier plus j slots of the block;
- any other cached call (a chunked prefill, plain attention over the cache)
  raises ``NotImplementedError``.

``cache_offset`` is an int, or a [B] tensor of per-row offsets (every
sequence at its own depth, as speculative decoding leaves them): the S new
K/V of row b land at slots ``offset[b] + arange(S)``.

The cache is updated **in place** (the JAX module returns an updated copy);
``forward_hidden`` returns the same dict it was given.

W8 serving weights (:func:`quantize_params`): every layer projection is a
``{"w8", "scale"}`` dict and the tied embedding an int8 row quantization.
Projections go through ``ops.quant.linear`` (dequantize, then one matmul);
on a decode step over W8 layers, the three fused W8 kernels of
``ops/decode_matmul.py`` (QKV, WO, MLP) run instead, over the stacked weights
at layer ``li``. The int8 LM head scales its f32 logits after the dot;
:func:`greedy_tokens` reaches the fused head-argmax kernel.

LoRA (:func:`add_lora`): low-rank adapters ``lora[key] = {A, B, s}`` beside
the stacked projections; every projection with an adapter adds
``(x @ A) @ B · s``, cached or not (a fused W8 decode kernel runs only
where its group of projections has no adapter). No LoRA dropout, as in the JAX module.

Training (the cache-free path with grad on): each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as ``jax.checkpoint`` wraps the
JAX module's layer scan; attention there is the plain masked ``mha``, as in
JAX. :func:`lm_logits` differentiates through its f32-output head product.

Not ported: the W8A8 and W4 modes and the pipeline.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Qwen3Config
from ..ops import quant
from ..ops.attention import combine_masks, make_causal_mask, mha
from ..ops.decode_attention import gqa_block_verify_attention, gqa_decode_attention
from ..ops.decode_matmul import fused_head_argmax, fused_linear_w8, fused_mlp_w8, fused_qkv_w8
from ..ops.flash_attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin
from .common import layer_views, normal, remat, torch_dtype

Params = Dict[str, object]

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
    ``torch.round`` rounds half to even, as ``jnp.round`` does. The scale is
    the row max times ``f32(1/127)``, the product XLA compiles the JAX
    module's ``/ 127.0`` to inside its layer scan."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1), 1e-8) * quant.inv_127(xf)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    ids = input_ids.long()
    if isinstance(emb, dict):  # W8: int8 rows × per-vocab scale, in the scale's dtype
        return emb["w8"][ids].to(emb["scale"].dtype) * emb["scale"][ids]
    return emb[ids]


# HF/PEFT module names (the stage YAML's lora.target_modules) → layer keys.
LORA_TARGET_MAP = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "gate", "up_proj": "up", "down_proj": "down",
}


def add_lora(params: Params, cfg: Qwen3Config, lora_cfg, gen: torch.Generator) -> Params:
    """Attach low-rank adapters: for each target projection W [L, in, out],
    ΔW = (A @ B)·α/r with A ~ N(0, 0.02²) [L, in, r], B = 0 [L, r, out] (the
    adapted model starts exactly at the base model) and the scale stored as
    a [L, 1] leaf ``s``. Returns a new tree; the base leaves are shared."""
    r, L = lora_cfg.rank, cfg.num_layers
    lora = {}
    for name in lora_cfg.target_modules:
        key = LORA_TARGET_MAP[name]
        w = params["layers"][key]
        in_dim, out_dim = (w["w8"] if isinstance(w, dict) else w).shape[-2:]
        dt = (w["scale"] if isinstance(w, dict) else w).dtype
        lora[key] = {
            "A": normal(gen, (L, in_dim, r), 0.02, dt),
            "B": torch.zeros((L, r, out_dim), dtype=dt, device=gen.device),
            "s": torch.full((L, 1), lora_cfg.scale, dtype=dt, device=gen.device),
        }
    out = dict(params)
    out["layers"] = dict(params["layers"], lora=lora)
    return out


def _maybe_lora(lp, key: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + the LoRA delta of projection ``key`` when an adapter is present,
    in the promoted dtype of x and the adapter, as JAX promotes them (bf16
    activations of W8 weights under f32 adapters)."""
    ad = lp.get("lora", {}).get(key)
    if ad is None:
        return y
    dt = torch.promote_types(x.dtype, ad["A"].dtype)
    return y + ((x.to(dt) @ ad["A"].to(dt)) @ ad["B"].to(dt)) * ad["s"][0]


def _linear(lp, key: str, x: torch.Tensor) -> torch.Tensor:
    return _maybe_lora(lp, key, x, quant.linear(x, lp[key]))


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _fused_groups(layers: Params) -> frozenset:
    """The projection groups of a decode step or verify block that run
    through the fused W8 kernels: each group whose projections are all W8
    and carry no LoRA adapter. As in the JAX module, each group is gated on
    its own adapters, so qkvo adapters leave the fused MLP running."""
    lora = layers.get("lora", {})
    return frozenset(g for g, keys in FUSED_GROUPS.items()
                     if all(isinstance(layers[k], dict) and k not in lora for k in keys))


def _layer_qkv(cfg: Qwen3Config, h, lp, cos, sin, stacked=None, li: int = 0, fused=frozenset()):
    """Pre-attention projections: normed x, rotated q/k, v. With "qkv" in
    ``fused`` (a decode step over W8 layers) one kernel launch computes q/k/v
    from the ``stacked`` weights at layer ``li``."""
    B, S, _ = h.shape
    D, NH, NKV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    x = rms_norm(h, lp["ln1"], cfg.rms_norm_eps)
    if "qkv" in fused:
        q, k, v = fused_qkv_w8(_rows(x), stacked["wq"], stacked["wk"], stacked["wv"], li)
    else:
        q, k, v = (_linear(lp, n, x) for n in ("wq", "wk", "wv"))
    q = rms_norm(q.reshape(B, S, NH, D), lp["q_norm"], cfg.rms_norm_eps)
    k = rms_norm(k.reshape(B, S, NKV, D), lp["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v.reshape(B, S, NKV, D)


def _layer_post_attn(cfg: Qwen3Config, h, lp, attn, stacked=None, li: int = 0, fused=frozenset()):
    """Output projection and MLP; the "wo" and "mlp" groups in ``fused`` run
    their fused W8 kernels over the ``stacked`` weights at layer ``li``."""
    B, S, H = h.shape
    a = attn.reshape(B, S, cfg.num_heads * cfg.head_dim)
    if "wo" in fused:
        h = h + fused_linear_w8(_rows(a), stacked["wo"], li).reshape(B, S, H)
    else:
        h = h + _linear(lp, "wo", a)
    x = rms_norm(h, lp["ln2"], cfg.rms_norm_eps)
    if "mlp" in fused:
        return h + fused_mlp_w8(_rows(x), stacked["gate"], stacked["up"], stacked["down"], li).reshape(B, S, H)
    return h + _linear(lp, "down", F.silu(_linear(lp, "gate", x)) * _linear(lp, "up", x))


def _row_write_plan(offset: torch.Tensor, S: int, T: int):
    """Where an S-position block lands per row at ``offset[b] + arange(S)``,
    as an index plan with no slot twice: row b writes the S distinct slots
    ``[base, base + S)``, ``base = min(offset[b], T − S)``, each slot taking
    block position ``slot − offset[b]`` where that is ≥ 0 and keeping its own
    content elsewhere. So positions past the cache's end (a finished row's
    block at the budget's edge) are dropped, as the JAX module's scatter
    drops them. Returns (rows [B, 1], slots [B, S], src [B, S], fresh [B, S])."""
    if S > T:
        raise ValueError(f"a block of {S} positions does not fit a cache of {T} slots")
    off = offset.long()
    slots = torch.clamp_max(off, T - S)[:, None] + torch.arange(S, device=off.device)
    src = slots - off[:, None]
    rows = torch.arange(off.shape[0], device=off.device)[:, None]
    return rows, slots, src.clamp_min(0), src >= 0


def _write_kv(buf: torch.Tensor, li: int, val: torch.Tensor, offset) -> None:
    """Write ``val`` [B, S, NKV, ...] (sequence-major) into layer ``li`` of
    the head-major ``buf`` [L, B, NKV, T, ...], in place: at slots
    ``offset + arange(S)`` for an int ``offset``, or per row by a
    :func:`_row_write_plan`."""
    if isinstance(offset, int):
        buf[li, :, :, offset:offset + val.shape[1]] = val.transpose(1, 2).to(buf.dtype)
        return
    rows, slots, src, fresh = offset
    layer = buf[li]
    # advanced indices split by the head slice: the indexed view is [B, S, NKV, ...]
    fresh = fresh.view(fresh.shape + (1,) * (val.ndim - 2))
    layer[rows, :, slots] = torch.where(fresh, val[rows, src].to(buf.dtype), layer[rows, :, slots])


def forward_hidden(
    params: Params,
    cfg: Qwen3Config,
    inputs_embeds: torch.Tensor,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_offset=0,
    prefill_padding: Optional[str] = None,
    decode_frontier: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run the decoder stack.

    Args:
        inputs_embeds: [B, S, H].
        attention_mask: [B, T] over key positions (T = cache length with a
            cache, else S), or [B, S, T] per query for a block verify; 1 =
            valid. None = all valid.
        positions: [B, S] rotary positions (default ``cache_offset +
            arange(S)``, per row for [B] offsets).
        cache: optional cache from :func:`init_cache`, written in place.
        cache_offset: slot where this segment's K/V are written: an int, or
            a [B] tensor of per-row offsets (with a cache and a mask that
            carries the causal frontier).
        prefill_padding: declares the prompt's valid slots one contiguous run
            per row (requires ``cache_offset == 0``) — the flash prefill.
        decode_frontier: declares each mask row one contiguous ``[start,
            end)`` run that already encodes causality — with S = 1 and a
            [B, T] mask, the decode-attention kernel; with [B] offsets, S > 1
            and a [B, S, T] mask (query j's row = query 0's plus j slots),
            the block-verify kernel.
    Returns:
        (hidden [B, S, H] after the final norm, the cache or None)
    """
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    per_row = isinstance(cache_offset, torch.Tensor) and cache_offset.ndim == 1
    if per_row:
        if cache is None or attention_mask is None:
            raise ValueError("per-row cache offsets need a cache and a frontier mask")
        cache_offset = cache_offset.to(device=dev, dtype=torch.int32)
        if positions is None:
            positions = cache_offset[:, None] + torch.arange(S, device=dev)[None, :]
    else:
        cache_offset = int(cache_offset)
        if positions is None:
            positions = (cache_offset + torch.arange(S, device=dev))[None, :].expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    layers = params["layers"]
    L = cfg.num_layers
    h = inputs_embeds

    if cache is None:  # causal x key padding, plain mha; recomputed per layer when differentiated
        pad = attention_mask[:, None, None, :].bool() if attention_mask is not None else None
        mask = combine_masks(make_causal_mask(S, S, q_offset=cache_offset, device=dev)[None, None], pad)

        def layer(h, lp):
            q, k, v = _layer_qkv(cfg, h, lp, cos, sin)
            return _layer_post_attn(cfg, h, lp, mha(q, k, v, mask=mask))

        for lp in layer_views(layers, L):
            h = remat(layer, h, lp)
        return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), None

    use_flash = prefill_padding is not None
    use_decode = decode_frontier and S == 1 and attention_mask is not None and attention_mask.ndim == 2
    use_verify = decode_frontier and per_row and S > 1 and attention_mask.ndim == 3
    if not (use_flash or use_decode or use_verify):
        raise NotImplementedError(
            "a cached call is a prefill (prefill_padding), a one-token decode step "
            "(decode_frontier with a [B, T] mask) or a speculative verify block "
            "(decode_frontier, [B] offsets and a [B, S, T] mask); chunked prefill and "
            "plain attention over the cache are not ported (ROADMAP: serving extras)"
        )
    if use_flash:
        if per_row or cache_offset != 0:
            raise ValueError("prefill_padding requires cache_offset == 0")
        prompt_mask = (attention_mask[:, :S].int() if attention_mask is not None
                       else torch.ones((B, S), dtype=torch.int32, device=dev))
        kv_start = torch.argmax(prompt_mask, dim=-1).int()
        kv_end = kv_start + prompt_mask.sum(-1).int()
    elif use_decode:
        am = attention_mask.int()
        f_start = torch.argmax(am, dim=-1).int()
        # causal clamp: a sloppier caller's mask must not see the future
        f_end = f_start + am.sum(-1).int()
        f_end = torch.minimum(f_end, cache_offset + 1) if per_row else f_end.clamp_max(cache_offset + 1)
    else:  # query 0's row gives the block's frontier; query j sees j slots more
        am0 = attention_mask[:, 0].int()
        f_start = torch.argmax(am0, dim=-1).int()
        f_off = torch.minimum(f_start + am0.sum(-1).int() - 1, cache_offset)
    quantized = "ks" in cache
    write_at = _row_write_plan(cache_offset, S, cache["k"].shape[3]) if per_row else cache_offset
    # a decode step or verify block over W8 layers runs the fused W8 kernels
    # (the prefill, like the JAX module's, dequantizes and multiplies)
    fused = _fused_groups(layers) if use_decode or use_verify else frozenset()

    for li, lp in enumerate(layer_views(layers, L)):
        q, k, v = _layer_qkv(cfg, h, lp, cos, sin, layers, li, fused)
        if quantized:
            k8, ks = _quantize_kv(k)
            v8, vs = _quantize_kv(v)
            for name, val in (("k", k8), ("v", v8), ("ks", ks), ("vs", vs)):
                _write_kv(cache[name], li, val, write_at)
        else:
            _write_kv(cache["k"], li, k, write_at)
            _write_kv(cache["v"], li, v, write_at)
        if use_flash:
            attn = flash_attention(q, k, v, causal=True, kv_start=kv_start, kv_end=kv_end)
        elif use_decode:
            attn = gqa_decode_attention(
                q[:, 0], cache["k"], cache["v"], li, f_start, f_end,
                cache.get("ks"), cache.get("vs"),
            )[:, None]
        else:
            attn = gqa_block_verify_attention(
                q.contiguous(), cache["k"], cache["v"], li, f_start, f_off,
                cache.get("ks"), cache.get("vs"),
            )
        h = _layer_post_attn(cfg, h, lp, attn, layers, li, fused)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache


QUANTIZED_LAYER_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
# the fused W8 decode kernels, each over its group of projections
FUSED_GROUPS = {"qkv": ("wq", "wk", "wv"), "wo": ("wo",), "mlp": ("gate", "up", "down")}


def quantize_rows(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[V, H] → {"w8": int8 [V, H], "scale": bf16 [V, 1]}, one scale per row.

    The row max is clamped to 1e-8 **before** the division by 127 — the
    opposite order from ``quant.quantize_per_channel``, as in the JAX
    module; both are kept."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(-1, keepdim=True), 1e-8) * quant.inv_127(wf)
    w8 = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"w8": w8, "scale": s.to(torch.bfloat16)}


def quantize_params(params: Params, *, embed: bool = True, donate: bool = True, mode: str = "w8") -> Params:
    """bf16 params → W8 serving params.

    Every layer projection (``QUANTIZED_LAYER_KEYS``) becomes per-output-
    channel int8; with ``embed`` the token embedding (the tied LM head)
    becomes int8 rows with per-vocab scales and an untied ``lm_head``
    per-channel int8. Norms stay as they are.

    ``donate`` (the JAX module donates each source matrix to its quantizer):
    the caller's dictionaries are updated in place, so each bf16 matrix is
    released as soon as its int8 copy exists. ``donate=False`` leaves the
    caller's tree as it was.
    """
    if mode != "w8":
        raise NotImplementedError(f"quantize mode {mode!r} is not ported yet (ROADMAP: W8A8/W4 modes)")
    out = params if donate else dict(params)
    layers = params["layers"] if donate else dict(params["layers"])
    out["layers"] = layers
    for key in QUANTIZED_LAYER_KEYS:
        layers[key] = quant.quantize_per_channel(layers[key])
    if embed:
        out["embed"] = quantize_rows(params["embed"])
        if "lm_head" in params:  # untied head [H, V]: per output channel
            out["lm_head"] = quant.quantize_per_channel(params["lm_head"])
    return out


class _HeadDot(torch.autograd.Function):
    """:func:`_head_dot` with its gradient: the f32 cotangent multiplies f32
    copies of the operands (the JAX transpose's f32 product; a bf16 rounding
    of the cotangent would change the gradient into the final hidden state
    and the tied embedding), and the gradients take the operands' dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _head_dot(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (g @ w.float().t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        gw = (x.float().t() @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def _head_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``x [N, H] @ w [H, V]``. On the card a GEMM in x's dtype
    accumulates and writes f32 (an int8 head is converted to that dtype,
    exactly); the CPU has no such call, so there the product runs on f32
    copies: the same exact products and f32 sums."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w.to(x.dtype), out_dtype=torch.float32)
    return x.float() @ w.float()


def lm_logits(params: Params, cfg: Qwen3Config, hidden: torch.Tensor) -> torch.Tensor:
    """LM head; float32 logits (the JAX einsum asks for an f32 result).

    An int8 head enters the dot unscaled and its f32 scale multiplies the
    result: per vocab row for the tied embedding, per column for an untied
    per-channel head."""
    x = hidden.reshape(-1, hidden.shape[-1])
    head = _HeadDot.apply if torch.is_grad_enabled() else _head_dot
    if cfg.tie_word_embeddings:
        w = params["embed"]
        if isinstance(w, dict):
            out = _head_dot(x, w["w8"].t()) * w["scale"][:, 0].float()
        else:
            out = head(x, w.t())
    else:
        w = params["lm_head"]
        if isinstance(w, dict):
            out = _head_dot(x, w["w8"]) * w["scale"][0].float()
        else:
            out = head(x, w)
    return out.reshape(*hidden.shape[:-1], out.shape[-1])


def greedy_head_eligible(params: Params, cfg: Qwen3Config) -> bool:
    """The fused head-argmax applies to a tied head held as a W8 embedding
    dict (the JAX gate's structural conditions; its TPU tiling conditions
    are not carried over)."""
    return cfg.tie_word_embeddings and isinstance(params.get("embed"), dict)


def greedy_tokens(params: Params, cfg: Qwen3Config, hidden: torch.Tensor) -> torch.Tensor:
    """Argmax over the LM head for the last position, [B] int32: the fused
    head-argmax kernel where :func:`greedy_head_eligible` (the [B, V] logits
    never exist), else :func:`lm_logits` + argmax. Ties go to the lowest
    index either way."""
    if hidden.ndim == 3:
        hidden = hidden[:, -1]
    if greedy_head_eligible(params, cfg):
        tok, _ = fused_head_argmax(hidden.contiguous(), params["embed"])
        return tok
    return torch.argmax(lm_logits(params, cfg, hidden), -1).to(torch.int32)


def forward_greedy(
    params: Params,
    cfg: Qwen3Config,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_offset=0,
    prefill_padding: Optional[str] = None,
    decode_frontier: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """:func:`forward` for pure greedy decode: (next token [B] int32, the
    cache), the head through :func:`greedy_tokens`."""
    if inputs_embeds is None:
        if input_ids is None:
            raise ValueError("forward_greedy needs input_ids or inputs_embeds")
        inputs_embeds = embed_tokens(params, input_ids)
    hidden, cache = forward_hidden(
        params, cfg, inputs_embeds,
        attention_mask=attention_mask, positions=positions, cache=cache,
        cache_offset=cache_offset, prefill_padding=prefill_padding,
        decode_frontier=decode_frontier,
    )
    return greedy_tokens(params, cfg, hidden), cache


def forward(
    params: Params,
    cfg: Qwen3Config,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_offset=0,
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
