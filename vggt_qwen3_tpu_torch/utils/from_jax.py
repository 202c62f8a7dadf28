"""Carry a JAX parameter tree, given as numpy arrays, over to PyTorch tensors.

Key names and the stacked ``[L, ...]`` layouts stay exactly as they are, so a
port module reads ``params["layers"]["wq"][li]`` where the JAX module scans
over the same leaf. ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``, so
bf16 arrays travel as their ``uint16`` bit pattern and are viewed back.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def array_to_torch(a, device="cpu") -> torch.Tensor:
    """One numpy (or array-like) leaf → tensor on ``device``, bit-exact."""
    a = np.array(a, copy=True, order="C")  # writable and contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree: Mapping[str, Any], device="cpu"):
    """Nested dict of arrays → the same nesting of tensors on ``device``.

    Covers the ``text``, ``vision`` and ``projector`` subtrees of
    ``vggt_qwen3_tpu.models.vlm.init_params`` (and any other plain nesting);
    subtrees the port does not run, such as ``geom``, carry over unchanged
    and are ignored.
    """
    if isinstance(tree, Mapping):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return array_to_torch(tree, device)
