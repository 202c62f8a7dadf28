"""QA inference CLI (ScanQA/SQA3D) on the card (counterpart of
``vggt_qwen3_tpu/inference/qa.py``).

Prompt ``f"{question}\\n<image>\\n"``, the expanding splice, greedy decode
with repetition penalty 1.1, the answer heuristics of
``postprocess_qa_answer``, unique-scene sampling with seed 42, JSONL records.

    python -m vggt_qwen3_tpu_torch.inference.qa --config configs/stage1_3d.yaml \\
        --glob 'data/processed/scanqa/*.jsonl' --num_samples 8 \\
        --max_new_tokens 32 --output_jsonl out.jsonl [--random_full] [--tiny] \\
        [--mock_vision] [--batch_size 8] [--speculative] [--device cuda]

Weights are random (seeded), or restored from a port checkpoint
(``--checkpoint_dir``, written by ``python -m vggt_qwen3_tpu_torch.train.sft``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from .. import resolve_device
from ..config import QWEN3_TINY, VGGT_TINY, PerceiverConfig, StageConfig, load_stage_config
from ..data.dataset import DatasetConfig, MultiViewJsonDataset
from ..data.tokenizer import IMAGE_TOKEN, load_tokenizer
from ..models import qwen3, vlm
from ..train import checkpoint as ckpt
from .batching import generate_batch, max_prompt_len
from .engine import GenerationConfig
from .postprocess import postprocess_qa_answer


def load_model(stage: StageConfig, checkpoint_dir: Optional[str] = None, rng_seed: int = 0, device="cuda"):
    """The model's params on ``device``: restored from a port checkpoint
    (a ``step_<n>`` directory written by ``train.sft`` on any mesh or by
    ``tools/convert_reference_ckpt``, or a directory holding them — the
    newest wins; LoRA adapters come with it), read whole by this process,
    else a random init from a seeded generator."""
    dev = resolve_device(device)
    if checkpoint_dir:
        path = Path(checkpoint_dir)
        step_dir = path if ckpt.is_step_dir(path) else ckpt.latest_step_dir(path)
        if step_dir is None:
            raise FileNotFoundError(f"no checkpoint (step_<n>/{ckpt.METADATA}) under {path}")
        print(f"restored checkpoint {step_dir}", flush=True)
        return ckpt.load_params(step_dir, dev)
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    return vlm.init_params(gen, stage.model, dtype=stage.model.dtype)


def pick_unique_scene_samples(dataset: MultiViewJsonDataset, num: int, seed: int) -> List[int]:
    """Random unique-scene subset."""
    rng = random.Random(seed)
    order = list(range(len(dataset)))
    rng.shuffle(order)
    seen, picked = set(), []
    for idx in order:
        scene = dataset.meta(idx).get("scene_id")
        if scene in seen:
            continue
        seen.add(scene)
        picked.append(idx)
        if len(picked) >= num:
            break
    return picked


def run_inference(
    params,
    stage: StageConfig,
    tokenizer,
    samples: List[Dict],
    *,
    max_new_tokens: int = 64,
    batch_size: int = 8,
    output_path: Optional[Path] = None,
    verbose: bool = True,
    quantize: bool = False,
    kv_dtype: Optional[str] = None,
    quant_mode: str = "w8",
    early_exit: bool = True,
    speculative: bool = False,
    pad_to_len: Optional[int] = None,
    append: bool = False,
    index_base: int = 0,
    device="cuda",
) -> List[Dict]:
    """Answer ``samples`` in batches on ``device`` (the params must be there).

    ``early_exit`` (default on) stops each batch's decode once every row hit
    EOS; tokens are identical to the fixed-length loop. ``speculative``:
    prompt-lookup speculative decoding (also token-identical; it wins when
    answers echo prompt spans). ``quantize`` serves the text model with
    quantized weights (``qwen3.quantize_params`` in ``quant_mode``: w8, w8a8
    or w4; the caller's tree left as it is): under w8 the decode steps run
    the fused W8 kernels, under w8a8 int8×int8 products and under w4 the
    packed-nibble products; the LM head is int8 in every mode."""
    dev = resolve_device(device)
    text_dev = params["text"]["final_norm"].device
    if text_dev.type != dev.type:
        raise ValueError(f"params are on {text_dev}, run asked for {dev}")
    if quantize:
        params = dict(params)
        params["text"] = qwen3.quantize_params(dict(params["text"]), donate=False, mode=quant_mode)
    gen_cfg = GenerationConfig(
        max_new_tokens=max_new_tokens,
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id,
        repetition_penalty=1.1,
        penalize_prompt=False,
        kv_dtype=kv_dtype,
    )
    if output_path is not None:
        output_path.parent.mkdir(parents=True, exist_ok=True)
        if not append:
            output_path.write_text("", encoding="utf-8")

    results: List[Dict] = []
    t0 = time.time()
    all_questions = [s.get("question") or s.get("instruction") or "" for s in samples]
    if pad_to_len is None:
        pad_to_len = max_prompt_len(tokenizer, [f"{q}\n{IMAGE_TOKEN}\n" for q in all_questions])
    for start in range(0, len(samples), batch_size):
        chunk = samples[start : start + batch_size]
        questions = all_questions[start : start + batch_size]
        prompts = [f"{q}\n{IMAGE_TOKEN}\n" for q in questions]
        tokens, lengths = generate_batch(
            params, stage, tokenizer, chunk, prompts, gen_cfg,
            pad_to_len=pad_to_len, pad_to_batch=batch_size,
            early_exit=early_exit, speculative=speculative,
        )
        for j, sample in enumerate(chunk):
            raw = tokenizer.decode(tokens[j][: lengths[j]], skip_special_tokens=True)
            record = {
                "index": index_base + start + j,
                "task": sample.get("task"),
                "scene_id": sample.get("scene_id"),
                "question": questions[j],
                "prediction": postprocess_qa_answer(raw, questions[j]),
                "reference": sample.get("answer"),
            }
            results.append(record)
            if output_path is not None:
                with output_path.open("a", encoding="utf-8") as f:
                    f.write(json.dumps(record, ensure_ascii=False) + "\n")
            if verbose:
                print(f"[{record['index']}] {questions[j]}\n → {record['prediction']}", flush=True)
    if verbose:
        dt = time.time() - t0
        print(f"{len(samples)} samples in {dt:.1f}s ({len(samples) / max(dt, 1e-9):.2f} samples/s)")
    return results


def build_stage(args) -> StageConfig:
    """Stage from the YAML; ``--tiny`` shrinks every model, ``--mock_vision``
    swaps VGGT for zero tokens. Without a checkpoint or ``--random_full`` the
    full model would be random anyway, so the tiny mock smoke mode is used."""
    if (getattr(args, "checkpoint_dir", None) is None
            and not (args.tiny or args.mock_vision)
            and not getattr(args, "random_full", False)):
        print("no --checkpoint_dir — falling back to --tiny --mock_vision smoke mode "
              "(random init); pass --random_full for the full-size random model", flush=True)
        args.tiny = True
        args.mock_vision = True
    stage = load_stage_config(
        args.config,
        text_config=QWEN3_TINY if args.tiny else None,
        vision_config=VGGT_TINY if args.tiny else None,
    )
    if args.tiny:
        stage = dataclasses.replace(
            stage,
            model=dataclasses.replace(
                stage.model,
                num_vis_tokens=min(stage.model.num_vis_tokens, 16),
                projector=PerceiverConfig(
                    latent_dim=64, num_latents=min(stage.model.num_vis_tokens, 16),
                    num_heads=4, num_layers=2, ffn_dim=128, dropout=0.0,
                ),
                dtype="float32",
            ),
            data=dataclasses.replace(stage.data, image_size=min(stage.data.image_size, 56)),
        )
    if args.mock_vision:
        stage = dataclasses.replace(
            stage, model=dataclasses.replace(stage.model, vision=None, vision_backbone="mock")
        )
    return stage


def main() -> None:
    p = argparse.ArgumentParser(description="ScanQA/SQA3D QA inference (PyTorch/CUDA port).")
    p.add_argument("--config", default="configs/stage1_3d.yaml")
    p.add_argument("--glob", default="data/processed/scanqa/*.jsonl")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--num_samples", type=int, default=20)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--output_jsonl", default="ckpts/qa_infer/qa_predictions.jsonl")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_root", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--mock_vision", action="store_true")
    p.add_argument("--random_full", action="store_true",
                   help="full-size model with seeded random weights")
    p.add_argument("--no_early_exit", action="store_true")
    p.add_argument("--speculative", action="store_true", help="prompt-lookup speculative decoding (token-exact)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    stage = build_stage(args)
    tokenizer = load_tokenizer(None if args.tiny else stage.tokenizer_path or stage.text_model_name)
    params = load_model(stage, args.checkpoint_dir, device=args.device)
    dataset = MultiViewJsonDataset(DatasetConfig(
        path_glob=args.glob, num_views=stage.data.num_views,
        image_size=stage.data.image_size, task="qa", root=args.data_root,
    ))
    samples = [dataset[i] for i in pick_unique_scene_samples(dataset, args.num_samples, args.seed)]
    run_inference(
        params, stage, tokenizer, samples,
        max_new_tokens=args.max_new_tokens, batch_size=args.batch_size,
        output_path=Path(args.output_jsonl) if args.output_jsonl else None,
        early_exit=not args.no_early_exit, speculative=args.speculative, device=args.device,
    )


if __name__ == "__main__":
    main()
