"""Greedy generation over the KV cache (counterpart of
``vggt_qwen3_tpu/inference/engine.py``).

One prefill over the (possibly vision-spliced) prompt, then single-token
decode steps: HF repetition penalty and no-repeat-ngram over the generated
tokens (the ``inputs_embeds`` semantics), finished rows emit
``pad_token_id``. ``generate_early_exit`` is a host ``while`` loop that stops
the step after every row is done (EOS or budget); ``generate`` runs all
``max_new_tokens`` steps. Tokens are identical either way.

Not ported in this slice: grammar constraints, prompt penalisation (the
text-only ARKit path), per-row budgets and the fused W8 head-argmax path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Qwen3Config
from ..models import qwen3
from ..ops.sampling import apply_no_repeat_ngram, apply_repetition_penalty, greedy_token


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    repetition_penalty: float = 1.0
    no_repeat_ngram: int = 0
    # prompt ids in the penalty/ngram sets: the text-only path, not ported yet
    penalize_prompt: bool = False
    # KV cache storage: None → model dtype; "int8" → per-(token, head) int8
    kv_dtype: Optional[str] = None


def unpack_lengths(packed: np.ndarray, gen_cfg: GenerationConfig):
    """``[B, N+1] = out | n_gen`` → (tokens [B, N], lengths [B]); lengths
    count up to and including EOS, clamped to the emitted total."""
    N = gen_cfg.max_new_tokens
    out, n_gen = packed[:, :N], packed[:, N]
    if gen_cfg.eos_token_id is not None:
        is_eos = out == gen_cfg.eos_token_id
        seen = np.cumsum(is_eos.astype(np.int32), axis=-1) - is_eos.astype(np.int32)
        lengths = np.minimum((seen == 0).astype(np.int32).sum(-1), n_gen)
    else:
        lengths = n_gen
    return out, lengths


def _check_supported(gen_cfg: GenerationConfig, constraint) -> None:
    if constraint is not None:
        raise NotImplementedError("constrained decoding belongs to the serving slice (ROADMAP: serving extras)")
    if gen_cfg.penalize_prompt:
        raise NotImplementedError("prompt penalisation (text-only ARKit path) is not ported yet (ROADMAP)")


def _decode(
    params, cfg: Qwen3Config, gen_cfg: GenerationConfig, inputs_embeds, attention_mask, *,
    early_exit: bool,
) -> Tuple[np.ndarray, int]:
    """Prefill + decode steps → (packed [B, N+1] = out | n_gen, steps run)."""
    B, S, _ = inputs_embeds.shape
    N = gen_cfg.max_new_tokens
    dev = inputs_embeds.device
    cache = qwen3.init_cache(cfg, B, S + N, dtype=gen_cfg.kv_dtype or cfg.dtype, device=dev)
    am = attention_mask.to(device=dev, dtype=torch.int32)
    mask = torch.zeros((B, S + N), dtype=torch.int32, device=dev)
    mask[:, :S] = am
    positions = torch.clamp_min(torch.cumsum(am, dim=-1) - 1, 0)

    logits, cache = qwen3.forward(
        params, cfg, inputs_embeds=inputs_embeds, attention_mask=mask,
        positions=positions, cache=cache, cache_offset=0,
        prefill_padding="left", last_logit_only=True,
    )
    next_logits = logits[:, -1]
    next_pos = positions[:, -1] + 1
    rows = torch.arange(B, device=dev)
    seen_ids = torch.zeros((B, N), dtype=torch.int32, device=dev)
    seen_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_gen = torch.zeros((B,), dtype=torch.int32, device=dev)
    out = torch.full((B, N), gen_cfg.pad_token_id, dtype=torch.int32, device=dev)

    t = 0
    while t < N and not (early_exit and bool(done.all())):
        processed = apply_repetition_penalty(next_logits, seen_ids, seen_len, gen_cfg.repetition_penalty)
        processed = apply_no_repeat_ngram(processed, seen_ids, seen_len, gen_cfg.no_repeat_ngram)
        tok = greedy_token(processed)
        out_tok = torch.where(done, torch.full_like(tok, gen_cfg.pad_token_id), tok)
        n_gen = torch.where(done, n_gen, n_gen + 1)
        if gen_cfg.eos_token_id is not None:
            done = done | (tok == gen_cfg.eos_token_id)
        done = done | (n_gen >= N)
        seen_ids[rows, seen_len.clamp(0, N - 1).long()] = out_tok
        seen_len = seen_len + 1
        out[:, t] = out_tok
        mask[:, S + t] = 1
        logits, cache = qwen3.forward(
            params, cfg, inputs_embeds=qwen3.embed_tokens(params, out_tok[:, None]),
            attention_mask=mask, positions=(next_pos + t)[:, None],
            cache=cache, cache_offset=S + t, decode_frontier=True,
        )
        next_logits = logits[:, 0]
        t += 1
    packed = torch.cat([out, n_gen[:, None]], dim=1).cpu().numpy()
    return packed, t


@torch.inference_mode()
def generate(
    params, cfg: Qwen3Config, gen_cfg: GenerationConfig, *,
    inputs_embeds: torch.Tensor, attention_mask: torch.Tensor, constraint=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy generation of all ``max_new_tokens`` steps.

    Returns (tokens [B, N] int32 — pad-filled after EOS, lengths [B] —
    generated tokens including EOS)."""
    _check_supported(gen_cfg, constraint)
    packed, _ = _decode(params, cfg, gen_cfg, inputs_embeds, attention_mask, early_exit=False)
    return unpack_lengths(packed, gen_cfg)


@torch.inference_mode()
def generate_early_exit(
    params, cfg: Qwen3Config, gen_cfg: GenerationConfig, *,
    inputs_embeds: torch.Tensor, attention_mask: torch.Tensor, constraint=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """:func:`generate` that stops once every row is done; also returns the
    number of decode steps run."""
    _check_supported(gen_cfg, constraint)
    packed, steps = _decode(params, cfg, gen_cfg, inputs_embeds, attention_mask, early_exit=True)
    out, lengths = unpack_lengths(packed, gen_cfg)
    return out, lengths, steps
