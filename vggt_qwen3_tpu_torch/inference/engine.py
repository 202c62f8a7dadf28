"""Greedy generation over the KV cache (counterpart of
``vggt_qwen3_tpu/inference/engine.py``).

One prefill over the (possibly vision-spliced) prompt, then single-token
decode steps: HF repetition penalty and no-repeat-ngram over the generated
tokens (the ``inputs_embeds`` semantics), or with ``penalize_prompt`` over
the prompt's ids too (HF's text-only call; :func:`generate_text`), finished
rows emit ``pad_token_id``. ``generate_early_exit`` is a host ``while`` loop that stops
the step after every row is done (EOS or per-row budget); ``generate`` runs
all ``max_new_tokens`` steps. Tokens are identical either way.

``constraint``: an optional FSM transition table ``[states + 1, V]`` (int16,
−1 = forbidden; ``inference/constrained.py``) on the device. Each step masks
the logits to the tokens its state allows (:func:`constrained_greedy`) and
advances the per-row state by one table lookup.

``generate``'s pure-greedy fast path: with no constraint, penalty 1.0, no
n-gram ban and a tied W8 head (``qwen3.greedy_head_eligible``) the only use
of the logits is an argmax, so the prefill and each step go through
``qwen3.forward_greedy`` (the fused head-argmax kernel) and carry the next
token instead of the logits. Its tokens and lengths are those of the slow
path.

Prompt penalisation copies the JAX module's buffer exactly: the seen ids
start as the prompt's ``[B, S]`` ids and the seen length as the number of
valid prompt tokens, and generated tokens are written from that length on.
With a left-padded row the penalty set is therefore the pads and a prefix
of the prompt, and the first tokens overwrite the prompt's tail; with no
padding it is HF's set (ROADMAP §3, inherited from the JAX package).
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
    # prompt ids in the penalty/ngram sets (HF's text-only call); with
    # inputs_embeds HF starts its rolling ids empty, so the vision path keeps
    # this False
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


def row_budget(budget, B: int, N: int, device) -> torch.Tensor:
    """Per-row token budgets as an int32 [B] tensor (default ``N``); each
    must be at least 1 (a 0-budget row would still emit one token)."""
    if budget is None:
        return torch.full((B,), N, dtype=torch.int32, device=device)
    budget = torch.as_tensor(budget).to(device=device, dtype=torch.int32)
    if not bool((budget >= 1).all()):
        raise ValueError("per-row budgets must be >= 1")
    return budget


def _processors(logits, seen_ids, seen_len, gen_cfg: GenerationConfig):
    logits = apply_repetition_penalty(logits, seen_ids, seen_len, gen_cfg.repetition_penalty)
    return apply_no_repeat_ngram(logits, seen_ids, seen_len, gen_cfg.no_repeat_ngram)


def seen_buffer(gen_cfg: GenerationConfig, attention_mask, prompt_ids, dev):
    """The logit processors' seen-token buffer [B, cap] and lengths [B]:
    ``cap = N`` and length 0, or with ``penalize_prompt`` ``cap = S + N``,
    the prompt's ids first (zeros without ``prompt_ids``) and the length the
    count of valid prompt tokens — the JAX module's buffer, pads included
    for a left-padded row."""
    B, S = attention_mask.shape
    N = gen_cfg.max_new_tokens
    if not gen_cfg.penalize_prompt:
        return (torch.zeros((B, N), dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
    seen_ids = torch.zeros((B, S + N), dtype=torch.int32, device=dev)
    if prompt_ids is not None:
        seen_ids[:, :S] = prompt_ids.to(device=dev, dtype=torch.int32)
    return seen_ids, attention_mask.to(device=dev, dtype=torch.int32).sum(-1, dtype=torch.int32)


def constrained_candidates(raw_logits, processed, fsm_state, constraint):
    """The logits greedy selection takes its argmax over, under an optional
    FSM table.

    The grammar masks the processed logits; a row where the processors
    banned every token the grammar allows (structural JSON tokens repeat, so
    the n-gram ban can hit them all) falls back to the grammar-masked raw
    logits: the grammar takes precedence over the processors."""
    if constraint is None:
        return processed
    allowed = constraint[fsm_state.long()] >= 0
    cand = processed.masked_fill(~allowed, float("-inf"))
    feasible = torch.isfinite(cand).any(-1, keepdim=True)
    return torch.where(feasible, cand, raw_logits.masked_fill(~allowed, float("-inf")))


def constrained_greedy(raw_logits, processed, fsm_state, constraint):
    """Greedy token under an optional FSM table: the one selection rule of
    every decode path (``generate``, early exit, speculative)."""
    return greedy_token(constrained_candidates(raw_logits, processed, fsm_state, constraint))


def advance_fsm(constraint, fsm_state, tok, moving):
    """The FSM state after ``tok`` where ``moving``: ``max(table[state, tok],
    0)``; unchanged elsewhere (and without a constraint)."""
    if constraint is None:
        return fsm_state
    nxt = constraint[fsm_state.long(), tok.long()].to(fsm_state.dtype)
    return torch.where(moving, nxt.clamp_min(0), fsm_state)


def _start(cfg: Qwen3Config, gen_cfg: GenerationConfig, inputs_embeds, attention_mask):
    """The empty cache, the [B, S+N] key mask with the prompt's slots set,
    and the prompt's rotary positions."""
    B, S, _ = inputs_embeds.shape
    N = gen_cfg.max_new_tokens
    dev = inputs_embeds.device
    cache = qwen3.init_cache(cfg, B, S + N, dtype=gen_cfg.kv_dtype or cfg.dtype, device=dev)
    am = attention_mask.to(device=dev, dtype=torch.int32)
    mask = torch.zeros((B, S + N), dtype=torch.int32, device=dev)
    mask[:, :S] = am
    return cache, mask, torch.clamp_min(torch.cumsum(am, dim=-1) - 1, 0)


def _decode(
    params, cfg: Qwen3Config, gen_cfg: GenerationConfig, inputs_embeds, attention_mask, *,
    early_exit: bool, prompt_ids=None, constraint=None, budget=None,
) -> Tuple[np.ndarray, int]:
    """Prefill + decode steps → (packed [B, N+1] = out | n_gen, steps run)."""
    B, S, _ = inputs_embeds.shape
    N = gen_cfg.max_new_tokens
    dev = inputs_embeds.device
    cache, mask, positions = _start(cfg, gen_cfg, inputs_embeds, attention_mask)

    logits, cache = qwen3.forward(
        params, cfg, inputs_embeds=inputs_embeds, attention_mask=mask,
        positions=positions, cache=cache, cache_offset=0,
        prefill_padding="left", last_logit_only=True,
    )
    next_logits = logits[:, -1]
    next_pos = positions[:, -1] + 1
    rows = torch.arange(B, device=dev)
    seen_ids, seen_len = seen_buffer(gen_cfg, attention_mask, prompt_ids, dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_gen = torch.zeros((B,), dtype=torch.int32, device=dev)
    fsm_state = torch.zeros((B,), dtype=torch.int32, device=dev)
    budget = row_budget(budget, B, N, dev)
    out = torch.full((B, N), gen_cfg.pad_token_id, dtype=torch.int32, device=dev)

    t = 0
    while t < N and not (early_exit and bool(done.all())):
        processed = _processors(next_logits, seen_ids, seen_len, gen_cfg)
        tok = constrained_greedy(next_logits, processed, fsm_state, constraint)
        fsm_state = advance_fsm(constraint, fsm_state, tok, ~done)
        out_tok = torch.where(done, torch.full_like(tok, gen_cfg.pad_token_id), tok)
        n_gen = torch.where(done, n_gen, n_gen + 1)
        if gen_cfg.eos_token_id is not None:
            done = done | (tok == gen_cfg.eos_token_id)
        done = done | (n_gen >= budget)
        seen_ids[rows, seen_len.clamp(0, seen_ids.shape[1] - 1).long()] = out_tok
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


def _decode_greedy(params, cfg: Qwen3Config, gen_cfg: GenerationConfig, inputs_embeds, attention_mask) -> np.ndarray:
    """The pure-greedy fast path: prefill + ``max_new_tokens`` steps through
    ``qwen3.forward_greedy``, carrying the next token. → packed [B, N+1]."""
    B, S, _ = inputs_embeds.shape
    N = gen_cfg.max_new_tokens
    dev = inputs_embeds.device
    cache, mask, positions = _start(cfg, gen_cfg, inputs_embeds, attention_mask)

    tok, cache = qwen3.forward_greedy(
        params, cfg, inputs_embeds=inputs_embeds, attention_mask=mask,
        positions=positions, cache=cache, cache_offset=0, prefill_padding="left",
    )
    next_pos = positions[:, -1] + 1
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    for t in range(N):
        out_tok = torch.where(done, torch.full_like(tok, gen_cfg.pad_token_id), tok)
        if gen_cfg.eos_token_id is not None:
            done = done | (tok == gen_cfg.eos_token_id)
        out[:, t] = out_tok
        mask[:, S + t] = 1
        tok, cache = qwen3.forward_greedy(
            params, cfg, inputs_embeds=qwen3.embed_tokens(params, out_tok[:, None]),
            attention_mask=mask, positions=(next_pos + t)[:, None],
            cache=cache, cache_offset=S + t, decode_frontier=True,
        )
    n_gen = torch.full((B, 1), N, dtype=torch.int32, device=dev)
    return torch.cat([out, n_gen], dim=1).cpu().numpy()


def greedy_fast_path(params, cfg: Qwen3Config, gen_cfg: GenerationConfig, constraint=None) -> bool:
    """Whether :func:`generate` takes the pure-greedy fast path."""
    return (constraint is None and gen_cfg.repetition_penalty == 1.0 and gen_cfg.no_repeat_ngram == 0
            and qwen3.greedy_head_eligible(params, cfg))


@torch.inference_mode()
def generate(
    params, cfg: Qwen3Config, gen_cfg: GenerationConfig, *,
    inputs_embeds: torch.Tensor, attention_mask: torch.Tensor, prompt_ids=None, constraint=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy generation of all ``max_new_tokens`` steps. ``prompt_ids``
    [B, S]: the ids backing the prompt, read only with ``penalize_prompt``.

    Returns (tokens [B, N] int32 — pad-filled after EOS, lengths [B] —
    generated tokens including EOS)."""
    if greedy_fast_path(params, cfg, gen_cfg, constraint):
        packed = _decode_greedy(params, cfg, gen_cfg, inputs_embeds, attention_mask)
    else:
        packed, _ = _decode(params, cfg, gen_cfg, inputs_embeds, attention_mask, early_exit=False,
                            prompt_ids=prompt_ids, constraint=constraint)
    return unpack_lengths(packed, gen_cfg)


@torch.inference_mode()
def generate_early_exit(
    params, cfg: Qwen3Config, gen_cfg: GenerationConfig, *,
    inputs_embeds: torch.Tensor, attention_mask: torch.Tensor, prompt_ids=None, constraint=None, budget=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """:func:`generate` that stops once every row is done; also returns the
    number of decode steps run. ``budget``: optional per-row token budgets
    [B] (each ≥ 1, at most ``max_new_tokens``); a row finishes after
    emitting its budget."""
    packed, steps = _decode(params, cfg, gen_cfg, inputs_embeds, attention_mask, early_exit=True,
                            prompt_ids=prompt_ids, constraint=constraint, budget=budget)
    out, lengths = unpack_lengths(packed, gen_cfg)
    return out, lengths, steps


@torch.inference_mode()
def generate_text(
    params, cfg: Qwen3Config, gen_cfg: GenerationConfig, *,
    input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None, constraint=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Text-only :func:`generate`: the embeddings looked up from
    ``input_ids`` [B, S] (on the params' device), which also back the
    penalty set under ``penalize_prompt``; the mask defaults to all valid."""
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    embeds = qwen3.embed_tokens(params, input_ids)
    return generate(params, cfg, gen_cfg, inputs_embeds=embeds, attention_mask=attention_mask,
                    prompt_ids=input_ids, constraint=constraint)
