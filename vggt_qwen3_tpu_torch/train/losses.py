"""Auxiliary loss heads (the port's own copy of ``vggt_qwen3_tpu/train/losses.py``).

The language loss plus a weighted L1 over numeric action fields and a plane
normal consistency term, with the stage-2 ``loss_heads:`` default weights.
As in the JAX package, nothing in the trainer calls :func:`combined_loss` yet:
the SFT step trains the language loss alone (``vlm.train_forward``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..models.vlm import causal_lm_loss


def action_json_loss(pred_fields: torch.Tensor, target_fields: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Weighted L1 over numeric action fields (center/normal/extent)."""
    return weight * (pred_fields - target_fields).abs().mean()


def geometry_consistency_loss(pred_normal: torch.Tensor, target_normal: torch.Tensor,
                              weight: float = 1.0) -> torch.Tensor:
    """1 − cosine similarity between predicted and target plane normals."""
    pn = pred_normal / (torch.linalg.norm(pred_normal, dim=-1, keepdim=True) + 1e-8)
    tn = target_normal / (torch.linalg.norm(target_normal, dim=-1, keepdim=True) + 1e-8)
    return weight * (1.0 - (pn * tn).sum(-1)).mean()


def combined_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    weights: Optional[Mapping[str, float]] = None,
    action_pred: Optional[torch.Tensor] = None,
    action_target: Optional[torch.Tensor] = None,
    normal_pred: Optional[torch.Tensor] = None,
    normal_target: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Stage-2 multi-head loss: ``language`` CE + optional ``action_json`` L1
    + optional ``geometry_consistency``; weights default to language 1.0,
    action_json 1.0, geometry_consistency 0.5."""
    w = {"language": 1.0, "action_json": 1.0, "geometry_consistency": 0.5}
    if weights:
        w.update(weights)
    losses: Dict[str, torch.Tensor] = {"language": w["language"] * causal_lm_loss(logits, labels)}
    if action_pred is not None and action_target is not None:
        losses["action_json"] = action_json_loss(action_pred, action_target, w["action_json"])
    if normal_pred is not None and normal_target is not None:
        losses["geometry_consistency"] = geometry_consistency_loss(
            normal_pred, normal_target, w["geometry_consistency"])
    losses["total"] = sum(losses.values())
    return losses
