"""Logit processors and greedy selection (counterpart of
``vggt_qwen3_tpu/ops/sampling.py``), over a static seen-token buffer plus a
per-row length, as the engine carries them.

HF semantics: repetition penalty divides positive and multiplies negative
logits of every seen token; no-repeat-ngram bans with -inf. With
``inputs_embeds`` prompts HF's rolling ids start empty, so the engine feeds
generated tokens only.
"""

from __future__ import annotations

import torch


def apply_repetition_penalty(
    logits: torch.Tensor, seen_ids: torch.Tensor, seen_len, penalty: float
) -> torch.Tensor:
    """logits [B, V] f32; seen_ids [B, T]; seen_len [B] or scalar."""
    if penalty == 1.0:
        return logits
    B, V = logits.shape
    T = seen_ids.shape[1]
    seen_len = torch.as_tensor(seen_len, device=logits.device).expand(B)
    valid = torch.arange(T, device=logits.device)[None, :] < seen_len[:, None]
    seen = torch.zeros((B, V), dtype=torch.int32, device=logits.device)
    seen = seen.scatter_reduce(1, seen_ids.long(), valid.int(), reduce="amax").bool()
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def apply_no_repeat_ngram(
    logits: torch.Tensor, seen_ids: torch.Tensor, seen_len, ngram: int
) -> torch.Tensor:
    """Ban any token x whose n-gram (last n-1 seen tokens, x) already occurs
    in ``seen_ids[:seen_len]``; no-op while fewer than n-1 tokens are seen."""
    if ngram <= 0:
        return logits
    B, V = logits.shape
    T = seen_ids.shape[1]
    dev = logits.device
    n1 = ngram - 1
    seen_ids = seen_ids.long()
    seen_len = torch.as_tensor(seen_len, device=dev).expand(B).long()
    rows = torch.arange(B, device=dev)[:, None]
    tail_pos = seen_len[:, None] - n1 + torch.arange(n1, device=dev)[None, :]
    tail = seen_ids[rows, tail_pos.clamp(0, T - 1)]  # [B, n1]
    idx = (torch.arange(T, device=dev)[:, None] + torch.arange(n1, device=dev)[None, :]).clamp(0, T - 1)
    windows = seen_ids[:, idx]  # [B, T, n1]
    match = (windows == tail[:, None, :]).all(-1)
    next_pos = torch.arange(T, device=dev) + n1
    hit = match & (next_pos[None, :] < seen_len[:, None])
    banned_tok = seen_ids[:, next_pos.clamp(0, T - 1)]  # [B, T]
    banned = torch.zeros((B, V), dtype=torch.int32, device=dev)
    banned = banned.scatter_reduce(1, banned_tok, hit.int(), reduce="amax").bool()
    banned = banned & (seen_len >= n1)[:, None]
    return logits.masked_fill(banned, float("-inf"))


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab — [B, V] → [B] int32 (first index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
