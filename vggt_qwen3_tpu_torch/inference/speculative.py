"""Prompt-lookup speculative decoding, greedy-exact (counterpart of
``vggt_qwen3_tpu/inference/speculative.py``).

Each iteration chooses token 0 exactly as ``engine.generate`` chooses a
token, drafts ``k`` more by n-gram lookup in the row's history (the prompt's
text ids, then the generated tokens), runs ONE forward over the ``k+1``-token
block, and keeps the longest prefix of drafts that the model itself would
have produced, with the logit processors and the constraint FSM applied at
every position. Tokens and lengths therefore equal ``generate``'s; only the
number of forwards changes.

Rows accept different counts, so sequences sit at different depths: the
verify forward uses ``qwen3.forward``'s per-row block path ([B] cache
offsets, a [B, k+1, T] per-query frontier mask, ``decode_frontier``), which
runs the block-verify attention kernel. Rejected drafts leave K/V past each
row's frontier; the mask hides them and the next block overwrites them.

The JAX module runs the whole loop as one compiled program ("fused") or one
program per block ("host"); here both modes are the same host loop, which
stops when every row is done.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Qwen3Config
from ..models import qwen3
from .engine import (
    GenerationConfig, _processors, advance_fsm, constrained_greedy, row_budget, seen_buffer, unpack_lengths,
)


def draft_lookup(ids_buf, ids_start, ids_len, tok0, k: int, ngram: int) -> torch.Tensor:
    """Prompt-lookup drafting over a per-row token history.

    The key is the last ``ngram-1`` history tokens plus the just-selected
    ``tok0``; among its earlier occurrences in ``[ids_start, ids_len)`` the
    one with the most continuation tokens available (capped at ``k``, the
    most recent among ties) wins — a short loop's most recent occurrence
    sits right behind the frontier with fewer than k tokens after it, one
    period earlier gives the full k.

    Returns ``drafts [B, k]`` int32 (0 where there is no match or the
    continuation is short; such drafts are rejected by verification)."""
    B, C = ids_buf.shape
    dev = ids_buf.device
    ids_buf = ids_buf.long()
    ids_len, ids_start = ids_len.long(), ids_start.long()
    rows = torch.arange(B, device=dev)[:, None]
    n1 = max(ngram - 1, 0)
    key_pos = ids_len[:, None] - n1 + torch.arange(n1, device=dev)[None, :]
    key = torch.cat([ids_buf[rows, key_pos.clamp(0, C - 1)], tok0.long()[:, None]], dim=1)  # [B, ngram]
    jj = torch.arange(C, device=dev)
    windows = ids_buf[:, (jj[:, None] + torch.arange(ngram, device=dev)[None, :]).clamp(0, C - 1)]
    match = (windows == key[:, None, :]).all(-1)  # [B, C]
    valid_j = (
        (jj[None, :] >= ids_start[:, None])
        # the window's history part ends before ids_len (tok0 is not written
        # yet), with at least one continuation token after it
        & (jj[None, :] + ngram <= ids_len[:, None])
        & ((ids_len - ids_start) >= n1)[:, None]  # the key must be real history
    )
    avail = (ids_len[:, None] - (jj[None, :] + ngram)).clamp(0, k)
    score = torch.where(match & valid_j & (avail > 0), avail * C + jj[None, :], -1)
    best = score.amax(-1)
    has = best >= 0
    p = torch.where(has, best % C, 0)
    d_idx = p[:, None] + ngram + torch.arange(k, device=dev)[None, :]
    d_ok = has[:, None] & (d_idx < ids_len[:, None])
    return torch.where(d_ok, ids_buf[rows, d_idx.clamp(0, C - 1)], 0).to(torch.int32)


class _Carry:
    """The per-row state of a speculative generation (tensors on the
    device), with :meth:`record` to emit one token where a row may."""

    def __init__(self, seen, N: int, lookup_ids, lookup_mask, pad_token_id: int, dev):
        self.seen_ids, self.seen_len = seen  # engine.seen_buffer: the processors' seen tokens
        B = self.seen_len.shape[0]
        self.rows = torch.arange(B, device=dev)
        # draft memory: the prompt's ids (their valid run ends at the prompt
        # region's edge: prompts are left-padded), then the generated tokens
        if lookup_ids is not None:
            SP = lookup_ids.shape[1]
            lm = (lookup_mask.to(device=dev, dtype=torch.int32) if lookup_mask is not None
                  else torch.ones((B, SP), dtype=torch.int32, device=dev))
            self.ids_buf = torch.zeros((B, SP + N), dtype=torch.int32, device=dev)
            self.ids_buf[:, :SP] = lookup_ids.to(device=dev, dtype=torch.int32)
            self.ids_start = SP - lm.sum(-1).int()
            self.ids_len = torch.full((B,), SP, dtype=torch.int32, device=dev)
        else:
            self.ids_buf = torch.zeros((B, N), dtype=torch.int32, device=dev)
            self.ids_start = torch.zeros((B,), dtype=torch.int32, device=dev)
            self.ids_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.fsm_state = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.out = torch.full((B, N), pad_token_id, dtype=torch.int32, device=dev)

    def record(self, emit, tok, out_at, constraint) -> None:
        """Where ``emit``: append ``tok`` to the seen ids, the draft memory
        and the output (at column ``out_at``), and advance the FSM."""
        for buf, at in ((self.seen_ids, self.seen_len), (self.ids_buf, self.ids_len), (self.out, out_at)):
            idx = at.clamp(0, buf.shape[1] - 1).long()
            buf[self.rows, idx] = torch.where(emit, tok, buf[self.rows, idx])
        self.seen_len = self.seen_len + emit.int()
        self.ids_len = self.ids_len + emit.int()
        self.fsm_state = advance_fsm(constraint, self.fsm_state, tok, emit)


@torch.inference_mode()
def generate_speculative(
    params,
    cfg: Qwen3Config,
    gen_cfg: GenerationConfig,
    *,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    prompt_ids: Optional[torch.Tensor] = None,
    lookup_ids: Optional[torch.Tensor] = None,
    lookup_mask: Optional[torch.Tensor] = None,
    constraint=None,
    budget=None,
    draft_k: int = 4,
    ngram: int = 3,
    mode: str = "fused",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """``engine.generate`` with prompt-lookup speculative decoding.

    Args match :func:`engine.generate`, plus:
        prompt_ids: [B, S] ids backing the prompt: the penalty set's prompt
            part under ``penalize_prompt``, and the draft memory's default
            (with ``attention_mask``).
        lookup_ids/lookup_mask: [B, S'] token history seeding the draft
            memory; on the vision path the pre-splice text ids. Used only
            for drafting, never for which tokens are produced.
        budget: per-row token budgets [B] (each ≥ 1; capped at
            ``max_new_tokens``).
        draft_k: drafted tokens per iteration (verify block k+1).
        ngram: lookup key length (the just-selected token plus the
            ``ngram-1`` before it).
        mode: "fused" or "host", as the JAX module names its two modes; both
            run the same host loop here.

    Returns (tokens [B, N] pad-filled, lengths [B], iterations): tokens and
    lengths are :func:`engine.generate`'s; iterations counts verify
    forwards."""
    if mode not in ("fused", "host"):
        raise ValueError(f"mode must be 'fused' or 'host', got {mode!r}")
    B, S, _ = inputs_embeds.shape
    N, k, eos = gen_cfg.max_new_tokens, draft_k, gen_cfg.eos_token_id
    dev = inputs_embeds.device
    budget = row_budget(budget, B, N, dev).clamp_max(N)
    if lookup_ids is None and prompt_ids is not None:
        lookup_ids, lookup_mask = prompt_ids, attention_mask

    # the cache holds S + N + k slots (the last block may start at n_gen =
    # N−1 and still write k+1), rounded up to 32 as the JAX module does
    T = -(-(S + N + k) // 32) * 32
    cache = qwen3.init_cache(cfg, B, T, dtype=gen_cfg.kv_dtype or cfg.dtype, device=dev)
    prompt_mask = attention_mask.to(device=dev, dtype=torch.int32)
    amask = F.pad(prompt_mask, (0, T - S))
    positions = torch.clamp_min(torch.cumsum(prompt_mask, dim=-1) - 1, 0)
    logits, cache = qwen3.forward(
        params, cfg, inputs_embeds=inputs_embeds, attention_mask=amask, positions=positions,
        cache=cache, cache_offset=0, prefill_padding="left", last_logit_only=True,
    )
    next_logits = logits[:, -1]
    next_pos = positions[:, -1] + 1
    c = _Carry(seen_buffer(gen_cfg, attention_mask, prompt_ids, dev), N, lookup_ids, lookup_mask,
               gen_cfg.pad_token_id, dev)
    n_gen = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    tpos = torch.arange(T, device=dev)[None, None, :]
    jpos = torch.arange(k + 1, device=dev)
    prompt_ok = amask.bool()[:, None, :]
    iters = 0
    while iters < N and not bool(done.all()):
        # token 0: exactly generate()'s selection
        processed0 = _processors(next_logits, c.seen_ids, c.seen_len, gen_cfg)
        tok0 = constrained_greedy(next_logits, processed0, c.fsm_state, constraint)
        drafts = draft_lookup(c.ids_buf, c.ids_start, c.ids_len, tok0, k, ngram)

        # one forward over [tok0, drafts]: query j sees the prompt and the
        # generated slots up to its own, [S, S + n_gen + j]
        gen_ok = (tpos - S) <= (n_gen[:, None, None] + jpos[None, :, None])
        block_mask = torch.where(tpos < S, prompt_ok, gen_ok).int()  # [B, k+1, T]
        logits, cache = qwen3.forward(
            params, cfg, input_ids=torch.cat([tok0[:, None], drafts], dim=1), attention_mask=block_mask,
            positions=next_pos[:, None] + jpos[None, :], cache=cache, cache_offset=S + n_gen,
            decode_frontier=True,
        )
        logits = logits.float()  # [B, k+1, V]

        # acceptance: emit tok0, then each draft while it is the model's token
        can0 = ~done & (n_gen < budget)
        c.record(can0, tok0, n_gen, constraint)
        a = can0.int()
        hit_eos = can0 & (tok0 == eos) if eos is not None else torch.zeros_like(done)
        alive = can0 & ~hit_eos & (n_gen + a < budget)
        for j in range(1, k + 1):
            prev = logits[:, j - 1]
            processed = _processors(prev, c.seen_ids, c.seen_len, gen_cfg)
            true_j = constrained_greedy(prev, processed, c.fsm_state, constraint)
            accept = alive & (drafts[:, j - 1] == true_j)
            c.record(accept, true_j, n_gen + a, constraint)
            a = a + accept.int()
            alive = accept
            if eos is not None:
                e = accept & (true_j == eos)
                hit_eos = hit_eos | e
                alive = accept & ~e
            alive = alive & (n_gen + a < budget)

        # the next token's logits: the model's output after the last emitted token
        gathered = logits[c.rows, (a - 1).clamp(0, k).long()]
        next_logits = torch.where((a > 0)[:, None], gathered, next_logits)
        n_gen = n_gen + a
        next_pos = next_pos + a
        done = done | hit_eos | (n_gen >= budget)
        iters += 1
    packed = torch.cat([c.out, n_gen[:, None]], dim=1).cpu().numpy()
    out, lengths = unpack_lengths(packed, gen_cfg)
    return out, lengths, iters
