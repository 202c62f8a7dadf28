"""Numerical-safety helpers (counterpart of ``vggt_qwen3_tpu/utils/debug.py``)
over the port's nested dicts of tensors; a leaf is named by its
``"a/b/c"`` path, as ``train.trainer.named_leaves`` names it.

- :func:`enable_nan_checks` — ``torch.autograd.set_detect_anomaly``. It is
  not JAX's ``jax_debug_nans``: JAX re-runs every jitted op that produced a
  NaN and raises there, forward ops included; anomaly mode checks the
  **backward** (a backward function that returns NaN raises, naming the
  forward op whose backward it was) and records forward traces for that
  message, but a NaN made by a forward op outside autograd passes unseen.
  Use :func:`check_finite` on forward outputs for those.
- :func:`check_finite` — raise ``FloatingPointError`` naming the leaves (up
  to 10) that hold a NaN or an infinity.
- :func:`tree_stats` — shape, mean, std and finiteness of every leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off (see the module note)."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/" if isinstance(v, dict) else f"{prefix}{k}")
    else:
        yield prefix, tree


def check_finite(tree: Any, name: str = "tree") -> None:
    """Raise if a floating-point leaf of ``tree`` holds a NaN or an infinity."""
    bad = [path for path, leaf in _leaves(tree)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(f"{name}: non-finite values in {bad[:10]}" + ("…" if len(bad) > 10 else ""))


def tree_stats(tree: Any) -> Dict[str, Dict[str, Any]]:
    """Leaf path → ``{"shape", "mean", "std", "finite"}`` (the statistics in
    f32, the std the population one, as numpy's; 0 for an empty leaf)."""
    out: Dict[str, Dict[str, Any]] = {}
    for path, leaf in _leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        arr = leaf.detach().float().cpu().numpy()
        out[path] = {
            "shape": tuple(arr.shape),
            "mean": float(arr.mean()) if arr.size else 0.0,
            "std": float(arr.std()) if arr.size else 0.0,
            "finite": bool(np.isfinite(arr).all()),
        }
    return out
