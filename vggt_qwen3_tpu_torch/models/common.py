"""Helpers shared by the port's models: dtype names, seeded normal init and
the hook every initialised leaf passes through, per-layer views of stacked weights, recompute for training, and the leaf
conversion of the checkpoint converters.

Parameters may be DTensors laid out by the sharding registry
(``parallel/sharding.py``): :func:`layer_views` then yields per-layer shards,
and each model function gathers what it reads on use (``full_tree``): a
layer's weights inside that layer's (recomputed) function, every other leaf
whole at the function's entry. Plain tensors pass through untouched."""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import LayerShard, unstack

Params = Dict[str, object]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """Config dtype string (or torch dtype) → torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


_LEAF_HOOK: ContextVar[Optional[Callable[[torch.Tensor], torch.Tensor]]] = ContextVar("leaf_hook", default=None)


@contextlib.contextmanager
def leaf_hook(fn: Callable[[torch.Tensor], torch.Tensor]) -> Iterator[None]:
    """Within: every leaf an ``init_params`` (and ``qwen3.add_lora``) makes
    goes through ``fn`` as soon as it is made, in the order it is made, and
    the tree holds what ``fn`` returns. A sharded init keeps each leaf's
    shard this way and frees the whole before the next leaf is drawn."""
    token = _LEAF_HOOK.set(fn)
    try:
        yield
    finally:
        _LEAF_HOOK.reset(token)


def made(x: torch.Tensor) -> torch.Tensor:
    """A leaf an init has just made, through the :func:`leaf_hook` if one is set."""
    fn = _LEAF_HOOK.get()
    return x if fn is None else fn(x)


def normal(gen: torch.Generator, shape, std: float, dt: torch.dtype) -> torch.Tensor:
    """N(0, std²) drawn in float32 from ``gen`` on its device, cast to ``dt``
    (a new leaf: :func:`made`)."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return made(x.normal_(0.0, std, generator=gen).to(dt))


def layer_views(lp: Params, L: int, stage=None) -> List[Dict[str, object]]:
    """The ``L`` per-layer views of stacked weights (W8 dicts and LoRA
    adapters leaf-wise), one ``unbind`` per leaf. Differentiated, each
    stacked leaf's gradient is then one stack of its layers' gradients;
    indexing ``w[li]`` layer by layer would instead add ``L`` full-size,
    zero-padded copies (the same values, ``L`` times the memory traffic).
    A DTensor leaf gives :class:`~..parallel.sharding.LayerShard` s, gathered
    by the layer's function. ``stage`` (the pipeline's mesh): this pp rank's
    ``L`` layers of its stage (``parallel.sharding.unstack``)."""
    per_leaf = {k: (layer_views(w, L, stage) if isinstance(w, dict) else unstack(w, stage))
                for k, w in lp.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(L)]


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant) when it is differentiated: grad on and a tensor argument,
    or a tensor in a dict argument, requires grad. Otherwise a plain call."""
    def needs(a):
        if isinstance(a, dict):
            return any(needs(t) for t in a.values())
        return isinstance(a, (torch.Tensor, LayerShard)) and a.requires_grad

    if torch.is_grad_enabled() and any(needs(a) for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def as_f32(x) -> torch.Tensor:
    """A checkpoint leaf (a tensor of any dtype, dense or sparse, or a numpy
    array) as a float32 CPU tensor, exactly: the converters go through f32,
    as the JAX package's go through f32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.to_dense() if x.layout != torch.strided else x).float().cpu()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def leaf(x, dt: torch.dtype, device) -> torch.Tensor:
    """A float32 tensor cast to ``dt`` (round to nearest even, as numpy's
    bf16 cast in the JAX converters) on ``device``, contiguous."""
    return x.to(dt).contiguous().to(device)
