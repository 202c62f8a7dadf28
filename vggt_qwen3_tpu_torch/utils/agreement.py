"""How a kernel's output is held against its plain version's.

A fixed absolute tolerance says little when the outputs are small: at the
VGGT global length (8232 keys, random q/k/v) attention outputs are about
0.015, so ``atol = 2e-2`` passes a kernel that leaves out a whole K/V tile.
The limits here scale with the reference:

- every element: ``|got − ref| ≤ tol·max|ref| + tol·|ref|``;
- all together: ``‖got − ref‖₂ ≤ (tol / 4)·‖ref‖₂``. This catches an error
  spread thinly over every row (a 1 % error in the softmax scale, one tile
  missing from the softmax sum) that the element-wise limit lets through.

With ``tol = 2e-2`` a right bf16 flash kernel measures about 2.5e-3 on the
second (one bf16 rounding of P and of the output).
"""

from __future__ import annotations

import torch


def agreement(got: torch.Tensor, ref: torch.Tensor, tol: float = 2e-2) -> dict:
    """Compare ``got`` with ``ref`` (same shape). Returns ``max_abs_err``
    beside ``abs_limit`` (tol·max|ref|, the element-wise limit's absolute
    part) and ``ref_mean_abs``; ``rel_rms`` (‖got − ref‖₂ / ‖ref‖₂) beside
    ``rel_rms_limit``; and ``ok``."""
    if got.shape != ref.shape:
        raise ValueError(f"agreement: shapes {tuple(got.shape)} and {tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    ref_max = r.abs().max().item()
    elementwise = bool((err <= tol * ref_max + tol * r.abs()).all())
    rel_rms = (err.norm() / r.norm().clamp_min(torch.finfo(torch.float32).tiny)).item()
    return dict(max_abs_err=err.max().item(), abs_limit=tol * ref_max, ref_mean_abs=r.abs().mean().item(),
                rel_rms=rel_rms, rel_rms_limit=tol / 4, ok=elementwise and rel_rms <= tol / 4)
