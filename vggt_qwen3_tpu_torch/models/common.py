"""Helpers shared by the port's models: dtype names, seeded normal init,
per-layer views of stacked weights and recompute for training."""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

Params = Dict[str, object]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """Config dtype string (or torch dtype) → torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def normal(gen: torch.Generator, shape, std: float, dt: torch.dtype) -> torch.Tensor:
    """N(0, std²) drawn in float32 from ``gen`` on its device, cast to ``dt``."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return x.normal_(0.0, std, generator=gen).to(dt)


def layer_views(lp: Params, L: int) -> List[Dict[str, object]]:
    """The ``L`` per-layer views of stacked weights (W8 dicts and LoRA
    adapters leaf-wise), one ``unbind`` per leaf. Differentiated, each
    stacked leaf's gradient is then one stack of its layers' gradients;
    indexing ``w[li]`` layer by layer would instead add ``L`` full-size,
    zero-padded copies (the same values, ``L`` times the memory traffic)."""
    per_leaf = {k: (layer_views(w, L) if isinstance(w, dict) else w.unbind(0)) for k, w in lp.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(L)]


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant) when it is differentiated: grad on and a tensor argument,
    or a tensor in a dict argument, requires grad. Otherwise a plain call."""
    def needs(a):
        if isinstance(a, dict):
            return any(needs(t) for t in a.values())
        return isinstance(a, torch.Tensor) and a.requires_grad

    if torch.is_grad_enabled() and any(needs(a) for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
