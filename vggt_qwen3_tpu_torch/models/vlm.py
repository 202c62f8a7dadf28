"""Composed vision-language model for inference (counterpart of
``vggt_qwen3_tpu/models/vlm.py``): VGGT → first ``num_vis_tokens`` of the
flattened last-layer tokens → Perceiver, and the inference splice that
replaces the first ``<image>`` token by the feature span.

Not ported in this slice: the geometry head (off the QA path), vision
quantisation, the training splice and losses (ROADMAP: training slice).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import VLMConfig
from . import perceiver, qwen3, vggt

Params = Dict[str, object]


def init_params(gen: torch.Generator, cfg: VLMConfig, dtype: Optional[str] = None) -> Params:
    """Random init of the text, projector and (unless mock) vision trees on
    ``gen.device``."""
    dt = dtype or cfg.dtype
    params: Params = {
        "text": qwen3.init_params(gen, cfg.text, dtype=dt),
        "projector": perceiver.init_params(
            gen, cfg.projector, in_dim=cfg.vision_out_dim, out_dim=cfg.text.hidden_size, dtype=dt,
        ),
    }
    if cfg.vision_backbone != "mock" and cfg.vision is not None:
        params["vision"] = vggt.init_params(gen, cfg.vision, dtype=dt)
    return params


def mock_aggregator(cfg: VLMConfig, images: torch.Tensor) -> Tuple[list, int]:
    """Zero-token stand-in honouring the real (tokens_list, patch_start_idx) contract."""
    B, S = images.shape[:2]
    return [torch.zeros((B, S, cfg.num_vis_tokens, cfg.mock_vision_dim),
                        dtype=images.dtype, device=images.device)], 5


def encode_images(params: Params, cfg: VLMConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, V, 3, H, W] in [0, 1] → [B, num_vis_tokens, text_hidden]."""
    B = images.shape[0]
    if cfg.vision_backbone == "mock":
        tokens_list, _ = mock_aggregator(cfg, images)
    else:
        tokens_list, _ = vggt.aggregator(params["vision"], cfg.vision, images)
    agg = tokens_list[-1]
    agg = agg.reshape(B, -1, agg.shape[-1])[:, : cfg.num_vis_tokens, :]
    return perceiver.apply(params["projector"], cfg.projector, agg)


def _first_image_pos(input_ids: torch.Tensor, image_token_id: int):
    is_img = input_ids == image_token_id
    return torch.argmax(is_img.int(), dim=-1), is_img.any(dim=-1)


def splice_expand(
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    input_ids: torch.Tensor,
    features: torch.Tensor,
    image_token_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace the first ``<image>`` token by the F-token feature span — the
    sequence grows by F−1. Rows without ``<image>`` keep their tokens and
    take padding after the original length."""
    B, T, H = inputs_embeds.shape
    Fv = features.shape[1]
    out_T = T + Fv - 1
    dev = inputs_embeds.device
    pos, has = _first_image_pos(input_ids, image_token_id)
    pos = torch.where(has, pos, torch.full_like(pos, T))
    j = torch.arange(out_T, device=dev)[None, :]
    p = pos[:, None]
    in_prefix = j < p
    in_vis = (j >= p) & (j < p + Fv)
    src_txt = torch.where(in_prefix, j, (j - (Fv - 1)).clamp(0, T - 1))
    src_vis = (j - p).clamp(0, Fv - 1)
    txt = torch.gather(inputs_embeds, 1, src_txt[:, :, None].expand(B, out_T, H))
    vis = torch.gather(features.to(inputs_embeds.dtype), 1, src_vis[:, :, None].expand(B, out_T, H))
    embeds = torch.where(in_vis[:, :, None], vis, txt)
    mask_txt = torch.gather(attention_mask, 1, src_txt)
    mask = torch.where(in_vis, torch.ones_like(mask_txt), mask_txt)
    mask = torch.where((~has[:, None]) & (j >= T), torch.zeros_like(mask), mask)
    return embeds, mask.to(attention_mask.dtype)
