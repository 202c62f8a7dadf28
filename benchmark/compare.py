"""The numbers that decide ``correct``, each beside its limit.

Training (:func:`training`), against the reference's run of the same micro
steps, each leaf's gap being the gap between the program's and the
reference's norm over the larger of the reference's norm of that leaf and
of the median leaf:

- ``grad_gap``: the worst leaf's gap of the first gradient;
- ``grad_error``: the median leaf's error of the first gradient, the norm
  of the difference over the same. The gaps between norms hardly see a
  lower precision: its round-off is unbiased and averages out of a norm
  summed over millions of elements, so the float8 control reads within
  the sound runs' spread on some seeds; the difference keeps it;
- ``update_gap``: the worst leaf's gap of the change by the first update.

The change by a later update is not compared: with the 8-bit moments'
linear codes, an element whose second moment rounds to code 0 while its
first does not takes a step of ``|mu| / √((1 − b2)·g²)`` at the next update,
without bound as its gradient nears 0, so a later change is ruled by a few
such elements and by the last bits of their gradients. Nor is the loss
(:func:`loss_gap`, logged): sound runs, the control and the faults read it
too close together for a limit (PERF.md gives the readings).

A leaf whose gradient in the reference stays under a thousandth of the
median leaf's at every followed step moves by round-off alone (a LoRA
``A`` while its ``B`` is zero, a scale with no gradient): it is left out of
the leaf-wise gaps, by that rule and not by name.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

MOVED = 1e-3  # a leaf counts where its reference gradient reaches this share of the median leaf's


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], counted: List[str]) -> Dict[str, float]:
    """Each counted leaf's gap of norms, over the larger of the reference's
    norm of that leaf and of the median leaf."""
    median = statistics.median(ref[n] for n in counted)
    return {n: abs(got[n] - ref[n]) / max(ref[n], median, 1e-30) for n in counted}


def counted_leaves(peak_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(peak_grad.values())
    return [n for n, g in peak_grad.items() if g >= MOVED * median]


def grad_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], counted: List[str],
                device) -> Dict[str, float]:
    """Each counted leaf's first-gradient error: the norm of the difference
    over the larger of the reference's norm of that leaf and of the median
    leaf, worked out on ``device`` a leaf at a time."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].to(device))) for n in counted}
    median = statistics.median(norms.values())
    return {n: float(torch.linalg.vector_norm(got[n].to(device).float() - ref[n].to(device).float()))
            / max(norms[n], median, 1e-30) for n in counted}


def training(got: dict, ref: dict, limits: Dict[str, float], device) -> List[tuple]:
    """(name, value, limit) of the training numbers."""
    counted = counted_leaves(ref["peak_grad"])
    errors = grad_errors(got["first_grads"], ref["first_grads"], counted, device)
    nums = {"grad_gap": max(leaf_gaps(got["first_grad"], ref["first_grad"], counted).values()),
            "grad_error": statistics.median(errors.values()),
            "update_gap": max(leaf_gaps(got["change"], ref["change"], counted).values())}
    return [(n, v, limits[n]) for n, v in nums.items()]


def loss_gap(got: dict, ref: dict) -> float:
    """The largest relative gap of a micro step's loss (logged, not compared:
    PERF.md gives its readings)."""
    return max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))


def report(got: dict, ref: dict, top: int = 3) -> Dict[str, str]:
    """The loss pairs and the largest leaf-wise gaps of each kind, for the
    run's log."""
    counted = counted_leaves(ref["peak_grad"])
    out = {"losses (program, reference)": str([(round(a, 5), round(b, 5)) for a, b in zip(got["losses"], ref["losses"])]),
           "loss_gap": f"{loss_gap(got, ref):.4g}"}
    for key, label in (("first_grad", "grad_gap"), ("change", "update_gap")):
        gaps = leaf_gaps(got[key], ref[key], counted)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:top]
        out[f"{label} worst leaves"] = ", ".join(f"{n} {gaps[n]:.3g} ({got[key][n]:.4g} vs {ref[key][n]:.4g})"
                                                 for n in worst)
    return out
