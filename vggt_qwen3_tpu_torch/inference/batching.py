"""Batch preparation for the QA CLI (counterpart of
``vggt_qwen3_tpu/inference/batching.py``): prompt encode → left pad →
preprocess and stack views → VGGT → Perceiver → embed → splice → generate.

Prompts pad to a caller-chosen length and short final chunks pad to the full
batch (rows repeated, outputs trimmed), as the JAX module does for its
compile-once shapes; here it keeps the kernels' shapes and the outputs the
same as the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import StageConfig
from ..data.tokenizer import IMAGE_TOKEN, pad_and_mask
from ..models import qwen3, vlm
from ..ops.preprocess import preprocess_views
from .engine import GenerationConfig, generate, generate_early_exit


def encode_prompts(tokenizer, prompts: List[str], *, pad_to_len: int) -> Tuple[np.ndarray, np.ndarray]:
    encoded = [tokenizer(p, add_special_tokens=False)["input_ids"] for p in prompts]
    padded = pad_and_mask(encoded, tokenizer.pad_token_id, min_length=pad_to_len, side="left")
    return np.asarray(padded["input_ids"], np.int32), np.asarray(padded["attention_mask"], np.int32)


def max_prompt_len(tokenizer, prompts: List[str]) -> int:
    return max(len(tokenizer(p, add_special_tokens=False)["input_ids"]) for p in prompts)


def stack_views(samples: List[Dict], image_size: int, device="cpu") -> torch.Tensor:
    """Preprocess each sample's views on ``device``; ragged view counts pad
    by repeating the last view → [B, V, 3, size, size]."""
    views = [preprocess_views(s["images"], image_size, device) for s in samples]
    v_max = max(v.shape[0] for v in views)
    views = [torch.cat([v] + [v[-1:]] * (v_max - v.shape[0]), dim=0) for v in views]
    return torch.stack(views, dim=0)


@torch.inference_mode()
def spliced_prompt(params, stage: StageConfig, image_token_id: int, images, ids, mask):
    """VGGT → Perceiver → embed → splice: (inputs_embeds, attention_mask)."""
    vis = vlm.encode_images(params, stage.model, images)
    embeds = qwen3.embed_tokens(params["text"], ids)
    return vlm.splice_expand(embeds, mask, ids, vis, image_token_id)


def generate_batch(
    params,
    stage: StageConfig,
    tokenizer,
    samples: List[Dict],
    prompts: List[str],
    gen_cfg: GenerationConfig,
    *,
    pad_to_len: int,
    pad_to_batch: Optional[int] = None,
    constraint=None,
    speculative: bool = False,
    early_exit: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run one spliced-prompt generation batch on the device the params are
    on. Returns (tokens [n, max_new], lengths [n]) for the n real samples."""
    if speculative:
        raise NotImplementedError("speculative decoding belongs to the serving slice (ROADMAP: serving extras)")
    dev = params["text"]["final_norm"].device  # a tensor in dense and W8 trees
    n = len(samples)
    if pad_to_batch and n < pad_to_batch:
        samples = samples + [samples[-1]] * (pad_to_batch - n)
        prompts = prompts + [prompts[-1]] * (pad_to_batch - n)
    ids_np, mask_np = encode_prompts(tokenizer, prompts, pad_to_len=pad_to_len)
    ids = torch.from_numpy(ids_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    images = stack_views(samples, stage.data.image_size, dev)
    image_token_id = tokenizer.convert_tokens_to_ids(IMAGE_TOKEN)
    embeds, mask2 = spliced_prompt(params, stage, image_token_id, images, ids, mask)
    kw = dict(inputs_embeds=embeds, attention_mask=mask2, constraint=constraint)
    if early_exit:
        tokens, lengths, _ = generate_early_exit(params["text"], stage.model.text, gen_cfg, **kw)
    else:
        tokens, lengths = generate(params["text"], stage.model.text, gen_cfg, **kw)
    return np.asarray(tokens)[:n], np.asarray(lengths)[:n]
