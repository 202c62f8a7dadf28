"""The QA cell's reference: one answered question, plainly.

:func:`served_logits` runs one sample — its views through the tower and the
Perceiver (no dropout), the question's ids with the first ``<image>``
replaced by the Perceiver's tokens, then the served tokens — through Qwen3
once, and returns the logits before each served token, with the repetition
penalty over the tokens served before it (HF's: a seen token's positive
logit divided by the penalty, a negative one multiplied). The weights are
the dense ones of ``benchmark/weights`` in float32.
"""

from __future__ import annotations

from typing import List

import torch

from . import model


def penalized(logits: torch.Tensor, served: List[int], penalty: float) -> torch.Tensor:
    """logits [n, V]: row j penalized over ``served[:j]``."""
    out = logits.clone()
    for j in range(1, logits.shape[0]):
        seen = torch.tensor(sorted(set(served[:j])), device=logits.device)
        row = out[j, seen]
        out[j, seen] = torch.where(row > 0, row / penalty, row * penalty)
    return out


@torch.no_grad()
def served_logits(w: dict, cfg: dict, images: torch.Tensor, ids: List[int], served: List[int], image_id: int,
                  penalty: float, prec: model.Prec) -> torch.Tensor:
    """images [V, 3, S, S]; ``ids`` the question's ids without padding →
    the penalized logits [len(served), vocab] before each served token."""
    tok = model.vggt_tokens(w["vision"], cfg["vision"], images[None], prec=prec)
    tok = tok.reshape(1, -1, tok.shape[-1])[:, :cfg["num_vis_tokens"]]
    feats = model.perceiver(w["projector"], cfg["projector"], tok, None, prec)[0]
    head = w["text"]["embed"].float()
    p = ids.index(image_id)
    dev = images.device
    seq = torch.cat([head[torch.tensor(ids[:p], device=dev)], feats, head[torch.tensor(ids[p + 1:], device=dev)],
                     head[torch.tensor(served[:-1], device=dev)]])
    hidden = model.text_hidden(w["text"], cfg["text"], seq[None], {}, prec)[0]
    n = len(served)
    logits = prec.mm(hidden[-n:], head.t())
    return penalized(logits, served, penalty)
