"""Composed vision-language model (counterpart of
``vggt_qwen3_tpu/models/vlm.py``): VGGT → first ``num_vis_tokens`` of the
flattened last-layer tokens → Perceiver, the geometry head, the inference
splice that replaces the first ``<image>`` token by the feature span, the
training splice that overwrites embeddings in place, and the training loss.

- :func:`encode_images` — under ``freeze_vision`` the tower runs under
  ``torch.no_grad()`` and its output is detached (JAX's ``stop_gradient``);
  otherwise the tower is differentiated (with recompute, ``models/vggt.py``).
  A ``generator`` turns on the Perceiver's training dropout.
- :func:`splice_overwrite` — the reference training splice: embeddings at
  ``pos : pos+F`` after the first ``<image>`` are overwritten, the sequence
  does not grow (answer embeddings it covers keep their labels, a reference
  quirk kept for parity).
- :func:`causal_lm_loss` / :func:`causal_lm_loss_chunked` — HF causal-LM
  shift, mean over labels ≠ −100; the chunked form never holds the
  [B, T, V] f32 logits (128 positions a chunk, each recomputed in the
  backward).
- :func:`train_forward` — geom tokens (when given) before the visual tokens,
  spliced over the first ``<image>``, the cache-free Qwen3 forward, the
  chunked loss.

Not ported: vision quantisation (``quantize_vision``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..config import VLMConfig
from . import geom as geom_mod
from . import perceiver, qwen3, vggt
from .common import remat

Params = Dict[str, object]


def init_params(gen: torch.Generator, cfg: VLMConfig, dtype: Optional[str] = None) -> Params:
    """Random init of the text, projector, geom and (unless mock) vision
    trees on ``gen.device``."""
    dt = dtype or cfg.dtype
    params: Params = {
        "text": qwen3.init_params(gen, cfg.text, dtype=dt),
        "projector": perceiver.init_params(
            gen, cfg.projector, in_dim=cfg.vision_out_dim, out_dim=cfg.text.hidden_size, dtype=dt,
        ),
    }
    if cfg.vision_backbone != "mock" and cfg.vision is not None:
        params["vision"] = vggt.init_params(gen, cfg.vision, dtype=dt)
    params["geom"] = geom_mod.init_params(gen, cfg.text.hidden_size, dtype=dt)
    return params


def mock_aggregator(cfg: VLMConfig, images: torch.Tensor) -> Tuple[list, int]:
    """Zero-token stand-in honouring the real (tokens_list, patch_start_idx) contract."""
    B, S = images.shape[:2]
    return [torch.zeros((B, S, cfg.num_vis_tokens, cfg.mock_vision_dim),
                        dtype=images.dtype, device=images.device)], 5


def encode_images(params: Params, cfg: VLMConfig, images: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, V, 3, H, W] in [0, 1] → [B, num_vis_tokens, text_hidden].

    Under ``cfg.freeze_vision`` no gradient enters the tower: it runs under
    ``torch.no_grad()``. ``generator`` enables the Perceiver's dropout."""
    B = images.shape[0]
    if cfg.vision_backbone == "mock":
        tokens_list, _ = mock_aggregator(cfg, images)
    elif cfg.freeze_vision:
        with torch.no_grad():
            tokens_list, _ = vggt.aggregator(params["vision"], cfg.vision, images)
    else:
        tokens_list, _ = vggt.aggregator(params["vision"], cfg.vision, images)
    agg = tokens_list[-1]
    agg = agg.reshape(B, -1, agg.shape[-1])[:, : cfg.num_vis_tokens, :]
    if cfg.freeze_vision:
        agg = agg.detach()
    return perceiver.apply(params["projector"], cfg.projector, agg, generator=generator)


def encode_geom(params: Params, cfg: VLMConfig, geom: Optional[Mapping[str, torch.Tensor]]):
    return geom_mod.apply(params["geom"], geom, cfg.geom_tokens)


def _first_image_pos(input_ids: torch.Tensor, image_token_id: int):
    is_img = input_ids == image_token_id
    return torch.argmax(is_img.int(), dim=-1), is_img.any(dim=-1)


def splice_overwrite(inputs_embeds: torch.Tensor, input_ids: torch.Tensor, features: torch.Tensor,
                     image_token_id: int) -> torch.Tensor:
    """Training splice: embeds[pos : pos+F] ← ``features`` (cast to the
    embeddings' dtype) after the first ``<image>``; length unchanged."""
    B, T, H = inputs_embeds.shape
    Fv = features.shape[1]
    pos, has = _first_image_pos(input_ids, image_token_id)
    rel = torch.arange(T, device=inputs_embeds.device)[None, :] - pos[:, None]
    valid = (rel >= 0) & (rel < Fv) & has[:, None]
    gathered = torch.gather(features, 1, rel.clamp(0, Fv - 1)[:, :, None].expand(B, T, H))
    return torch.where(valid[:, :, None], gathered.to(inputs_embeds.dtype), inputs_embeds)


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


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of −log p(target) over targets ≠ −100, their count) from f32 logits."""
    valid = targets != -100
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, targets, 0).long()[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """HF CausalLM loss: shift-by-one CE, mean over labels ≠ −100."""
    total, count = _nll_sum(logits[:, :-1].float(), labels[:, 1:])
    return total / count.clamp_min(1)


def causal_lm_loss_chunked(text_params, text_cfg, hidden: torch.Tensor, labels: torch.Tensor, *,
                           chunk: int = 128) -> torch.Tensor:
    """:func:`causal_lm_loss` over the LM head evaluated ``chunk`` positions
    at a time, each chunk recomputed in the backward: the peak holds one
    [B, chunk, V] f32 chunk. ``hidden`` is the post-final-norm state
    [B, T, H]; the shift happens here. The chunk sums are added in order in
    f32, as JAX's scan adds them."""
    B, T, H = hidden.shape
    hs, targets = hidden[:, :-1], labels[:, 1:]
    n = T - 1
    pad = (-n) % chunk
    if pad:
        hs = torch.cat([hs, hs.new_zeros((B, pad, H))], dim=1)
        targets = torch.cat([targets, targets.new_full((B, pad), -100)], dim=1)

    def body(h_c, t_c):
        return _nll_sum(qwen3.lm_logits(text_params, text_cfg, h_c), t_c)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, n + pad, chunk):
        s, c = remat(body, hs[:, c0:c0 + chunk], targets[:, c0:c0 + chunk])
        total = total + s
        count = count + c
    return total / count.clamp_min(1)


def train_forward(
    params: Params,
    cfg: VLMConfig,
    *,
    images: torch.Tensor,
    geom_token: Optional[Mapping[str, torch.Tensor]],
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    labels: torch.Tensor,
    image_token_id: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Training loss: geom tokens (when present) concatenated **before** the
    visual tokens, the combined span overwriting embeddings at the first
    ``<image>``, then the chunked causal-LM loss."""
    vis = encode_images(params, cfg, images, generator=generator)
    geom_feats = encode_geom(params, cfg, geom_token)
    if geom_feats is None:
        features = vis
    else:
        dt = torch.promote_types(geom_feats.dtype, vis.dtype)
        features = torch.cat([geom_feats.to(dt), vis.to(dt)], dim=1)
    embeds = qwen3.embed_tokens(params["text"], input_ids)
    embeds = splice_overwrite(embeds, input_ids, features, image_token_id)
    hidden, _ = qwen3.forward_hidden(params["text"], cfg.text, embeds, attention_mask=attention_mask)
    return causal_lm_loss_chunked(params["text"], cfg.text, hidden, labels)
