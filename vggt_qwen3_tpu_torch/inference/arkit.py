"""ARKit RoomPlan action-JSON inference CLI on the card (counterpart of
``vggt_qwen3_tpu/inference/arkit.py``).

System-hint prompt, the first N scenes with no shuffling, greedy decode with
repetition penalty 1.1, ``no_repeat_ngram=4`` and ``max_new_tokens=256``,
prompt-echo stripping and first-balanced-JSON extraction, and exact match
over sort-keys-canonicalised references. ``--constrained_json`` masks the
decode with the action-JSON FSM (``inference/constrained.py``);
``--speculative`` decodes by prompt-lookup speculative blocks
(``inference/speculative.py``, token-exact).

    python -m vggt_qwen3_tpu_torch.inference.arkit --config configs/stage2_arkit.yaml \\
        --glob data/processed/arkit_synth/test.json [--constrained_json] [--speculative] \\
        [--random_full] [--tiny] [--mock_vision] [--device cuda]

Weights are random (seeded), or restored from a port checkpoint
(``--checkpoint_dir``, through ``qa.load_model``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .. import resolve_device
from ..config import StageConfig
from ..data.dataset import DatasetConfig, MultiViewJsonDataset
from ..data.tokenizer import IMAGE_TOKEN, load_tokenizer
from .batching import generate_batch, max_prompt_len
from .constrained import action_json_constraint
from .engine import GenerationConfig
from .postprocess import extract_first_json, postprocess_arkit_generation
from .qa import build_stage, load_model

SYSTEM_HINT = (
    "You are a RoomPlan assistant. Given multi-view images and an instruction, "
    "reply with only the final JSON action using keys action, scene, center, normal, extent. "
    "Do not repeat the instruction text."
)


def prompt_for(question: str) -> str:
    return f"{SYSTEM_HINT}\nInstruction: {question}\n{IMAGE_TOKEN}\n"


def load_arkit_samples(glob_pattern: str, max_scenes: int, num_views: int,
                       image_size: int, root: Optional[str] = None) -> List[Dict]:
    """The first ``max_scenes`` scenes, no shuffling."""
    dataset = MultiViewJsonDataset(
        DatasetConfig(path_glob=glob_pattern, num_views=num_views,
                      image_size=image_size, task="arkit_synth", root=root)
    )
    return [dataset[i] for i in range(min(max_scenes, len(dataset)))]


def run_inference(
    params,
    stage: StageConfig,
    tokenizer,
    samples: List[Dict],
    *,
    max_new_tokens: int = 256,
    batch_size: int = 4,
    output_path: Optional[Path] = None,
    compute_metrics: bool = True,
    verbose: bool = True,
    constrained_json: bool = False,
    speculative: bool = False,
    device="cuda",
    stats: Optional[List[Dict]] = None,
) -> Tuple[List[Dict], Optional[Dict[str, float]]]:
    """Predict an action for each of ``samples`` on ``device`` (the params
    must be there). Returns (records, exact-match metrics or None).

    ``constrained_json``: every generation is a parseable ``{action, scene,
    center, normal, extent}`` object by construction (off by default: free
    decode and post-hoc brace extraction, as the reference does).
    ``speculative``: prompt-lookup speculative decoding; the action JSON's
    repeated key skeleton is its high-acceptance case.
    ``stats``: if given, one dict is appended per batch: its ``tokens`` and
    ``lengths`` and ``iterations`` (speculative iterations, else None)."""
    dev = resolve_device(device)
    text_dev = params["text"]["final_norm"].device
    if text_dev.type != dev.type:
        raise ValueError(f"params are on {text_dev}, run asked for {dev}")
    gen_cfg = GenerationConfig(
        max_new_tokens=max_new_tokens,
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id,
        repetition_penalty=1.1,
        no_repeat_ngram=4,
        penalize_prompt=False,
    )
    constraint = None
    if constrained_json:
        table = action_json_constraint(tokenizer, vocab_size=stage.model.text.vocab_size)
        constraint = torch.from_numpy(table).to(text_dev)
    if output_path is not None:
        output_path.parent.mkdir(parents=True, exist_ok=True)
        output_path.write_text("", encoding="utf-8")

    results: List[Dict] = []
    total_with_ref = 0
    total_exact = 0
    all_questions = [s.get("question") or s.get("instruction") or "" for s in samples]
    pad_to_len = max_prompt_len(tokenizer, [prompt_for(q) for q in all_questions])
    for start in range(0, len(samples), batch_size):
        chunk = samples[start : start + batch_size]
        questions = all_questions[start : start + batch_size]
        prompts = [prompt_for(q) for q in questions]
        batch_stats: Dict = {}
        tokens, lengths = generate_batch(
            params, stage, tokenizer, chunk, prompts, gen_cfg,
            pad_to_len=pad_to_len, pad_to_batch=batch_size, constraint=constraint,
            speculative=speculative, stats=batch_stats,
        )
        if stats is not None:
            stats.append(dict(batch_stats, tokens=tokens, lengths=lengths))
        for j, sample in enumerate(chunk):
            raw_text = tokenizer.decode(tokens[j][: lengths[j]], skip_special_tokens=True).strip()
            # the engine returns new tokens only, but the reference's cleanup is kept for parity
            prediction = extract_first_json(postprocess_arkit_generation(raw_text, prompts[j], questions[j]))
            reference = sample.get("answer")
            record = {
                "index": start + j,
                "scene_id": sample.get("scene_id"),
                "question": questions[j],
                "prediction": prediction,
                "raw_prediction": extract_first_json(raw_text),
                "reference": reference,
            }
            results.append(record)
            if output_path is not None:
                with output_path.open("a", encoding="utf-8") as f:
                    f.write(json.dumps(record, ensure_ascii=False) + "\n")
            if compute_metrics and reference is not None:
                total_with_ref += 1
                ref_str = (json.dumps(reference, sort_keys=True) if isinstance(reference, (dict, list))
                           else str(reference))
                if ref_str.strip() == prediction.strip():
                    total_exact += 1
            if verbose:
                print(f"[{start + j}] {questions[j]}\n → {prediction}", flush=True)

    metrics: Optional[Dict[str, float]] = None
    if compute_metrics and total_with_ref > 0:
        metrics = {
            "num_samples": len(samples),
            "num_with_reference": total_with_ref,
            "exact_match": total_exact / float(total_with_ref),
        }
        if verbose:
            print(f"\nSummary over {total_with_ref} samples with reference:"
                  f" exact_match = {metrics['exact_match']:.3f}")
    return results, metrics


def main() -> None:
    p = argparse.ArgumentParser(description="ARKit RoomPlan action inference (PyTorch/CUDA port).")
    p.add_argument("--config", default="configs/stage2_arkit.yaml")
    p.add_argument("--glob", default="data/processed/arkit_synth/*.json")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--max_scenes", type=int, default=9)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--output_jsonl", default="ckpts/arkit_infer/predictions.jsonl")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--data_root", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--mock_vision", action="store_true")
    p.add_argument("--random_full", action="store_true",
                   help="full-size model with seeded random weights")
    p.add_argument("--constrained_json", action="store_true",
                   help="FSM-mask the decode to the action-JSON schema (every output parses)")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (token-exact)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    stage = build_stage(args)
    tokenizer = load_tokenizer(None if args.tiny else stage.tokenizer_path or stage.text_model_name)
    params = load_model(stage, args.checkpoint_dir, device=args.device)
    samples = load_arkit_samples(
        args.glob, args.max_scenes, stage.data.num_views, stage.data.image_size, args.data_root
    )
    t0 = time.time()
    run_inference(
        params, stage, tokenizer, samples,
        max_new_tokens=args.max_new_tokens,
        batch_size=args.batch_size,
        output_path=Path(args.output_jsonl) if args.output_jsonl else None,
        constrained_json=args.constrained_json,
        speculative=args.speculative,
        device=args.device,
    )
    print(f"total {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
