"""The training cells' reference: the first micro steps of a QLoRA recipe,
followed plainly from the seed.

:func:`follow` draws the weights again from the seed (``benchmark/weights``),
quantizes the frozen ones as the configuration states (the tower W8A8, the
Qwen3 base W8), and runs the given batches through :func:`loss` — the tower,
the Perceiver with its dropout, the geometry head, the splice over the first
``<image>``, Qwen3 with LoRA and the cross-entropy — differentiating the
trainable leaves (projector, geometry head, adapters) in float32 and handing
each micro step's gradients to ``reference/optim.AdamW``. It returns each
micro step's loss, each leaf's first gradient (and its norm), the largest
norm each leaf's gradient reached, and each leaf's change by the first
update.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import weights
from . import model, optim

TRAINABLE_GROUPS = ("projector", "geom")


def trainable_names(tree: dict) -> List[str]:
    """The leaves a QLoRA step trains: projector, geometry head, adapters."""
    return [n for n, _ in weights.leaves(tree)
            if n.split("/")[0] in TRAINABLE_GROUPS or n.startswith("text/layers/lora/")]


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for name, t in flat.items():
        node = out
        keys = name.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out


def tower(vis: dict, cfg: dict, images: torch.Tensor, prec: model.Prec) -> torch.Tensor:
    """The first ``num_vis_tokens`` of the last pair's flattened tokens."""
    tok = model.vggt_tokens(vis, cfg["vision"], images, prec)
    B = tok.shape[0]
    return tok.reshape(B, -1, tok.shape[-1])[:, :cfg["num_vis_tokens"]]


def loss(cfg: dict, text: dict, head: torch.Tensor, train: dict, tokens: torch.Tensor, batch: dict,
         gen: Optional[torch.Generator], prec: model.Prec) -> torch.Tensor:
    """One micro step's loss from the tower's tokens (``train``: the nested
    trainable leaves in float32)."""
    vis = model.perceiver(train["projector"], cfg["projector"], tokens, gen, prec)
    feats = torch.cat([model.geom_tokens(train["geom"], batch["geom_token"], cfg["geom_tokens"], prec), vis], dim=1)
    ids = batch["input_ids"]
    embeds = model.splice(head[ids], ids, feats, batch["image_token_id"])
    hidden = model.text_hidden(text, cfg["text"], embeds, train["text"]["layers"]["lora"], prec)
    return model.lm_loss(hidden, head.t(), batch["labels"], prec)


def quantized(cfg: dict, seed: int, device) -> dict:
    """The weights from the seed, the frozen ones in the configuration's
    formats: ``{"vision", "text", "head", "train"}`` (``train``: name →
    bfloat16 leaf)."""
    w = weights.make(cfg, seed, device, lora=True)
    names = trainable_names(w)
    train = dict((n, t) for n, t in weights.leaves(w) if n in names)
    vision = model.quantize_tower(w.pop("vision")) if cfg["vision_quant"] == "w8a8" else w.pop("vision")
    text = w.pop("text")
    if cfg["text_quant"] == "w8":
        text = model.quantize_text(text)
    return {"vision": vision, "text": text, "head": model.embed_dense(text), "train": train}


def follow(cfg: dict, seed: int, batches: List[dict], gen_seeds: List[int], device, prec: model.Prec,
           *, rows: Optional[int] = None, tokens_cache: Optional[Dict[int, torch.Tensor]] = None,
           state: Optional[dict] = None, start_update: int = 0) -> dict:
    """Micro steps ``0 … len(batches) − 1`` of the recipe from the seed's
    weights. ``rows``: only the first rows of each batch (a fault of the
    check). ``tokens_cache``: the tower's tokens of each step, filled and
    reused (the tower is frozen: one cache a precision).
    ``state``: :func:`quantized`'s, made here when not given.
    ``start_update``: the schedule's count of the first update."""
    model.strict_float32()
    st = state if state is not None else quantized(cfg, seed, device)
    train = {n: t.clone() for n, t in st["train"].items()}
    start = {n: t.clone() for n, t in train.items()}
    opt = optim.AdamW(cfg, train)
    opt.count = start_update
    losses, first, first_grads, peak, change = [], {}, {}, {n: 0.0 for n in train}, None
    for i, (batch, gs) in enumerate(zip(batches, gen_seeds)):
        b = {k: (v[:rows] if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}
        b["geom_token"] = {k: v[:rows] for k, v in batch["geom_token"].items()}
        if tokens_cache is not None and i in tokens_cache:
            tokens = tokens_cache[i][:rows]
        else:
            tokens = tower(st["vision"], cfg, b["pixel_values"], prec)
            if tokens_cache is not None and rows is None:
                tokens_cache[i] = tokens
        leaves = {n: t.float().requires_grad_(True) for n, t in train.items()}
        gen = torch.Generator(device=device).manual_seed(gs)
        value = loss(cfg, st["text"], st["head"], _nest(leaves), tokens, b, gen, prec)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        losses.append(float(value.detach()))
        for n, g in grads.items():
            norm = float(torch.linalg.vector_norm(g))
            peak[n] = max(peak[n], norm)
            if i == 0:
                first[n] = norm
                first_grads[n] = g.detach().to("cpu", copy=True)
        del leaves, value
        if opt.step(grads) and change is None:
            change = {n: float(torch.linalg.vector_norm(train[n].float() - start[n].float())) for n in train}
            del start
    return {"losses": losses, "first_grad": first, "first_grads": first_grads, "peak_grad": peak, "change": change}
