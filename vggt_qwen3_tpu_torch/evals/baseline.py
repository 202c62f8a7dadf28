"""Baseline evaluation (counterpart of ``vggt_qwen3_tpu/evals/baseline.py``;
reference ``scripts/eval_baseline_quick.py``).

Runs QA inference over the SQA3D/ScanQA/ARKit test splits and computes
exact/partial match with the reference's metric semantics
(``eval_baseline_quick.py:36-135``): string refs — exact = case-insensitive
stripped equality, partial = substring either direction; dict refs — partial =
``ref['action'] in pred``, exact = parsed-JSON equality. Writes
``baseline_summary.json`` (``:209-211``). The model loads once and answers
every split in-process, in batches.

    python -m vggt_qwen3_tpu_torch.evals.baseline --config configs/stage1_3d.yaml \\
        --num_samples 50 --max_new_tokens 32 --output_dir outputs/qa/baseline_eval \\
        [--datasets sqa3d scanqa arkit] [--glob NAME=GLOB] [--data_root DIR] \\
        [--compare_quant --quant_mode w8|w8a8|w4] [--serve_quant none|w8|w8a8] \\
        [--checkpoint_dir DIR | --random_full | --tiny --mock_vision] [--device cuda]

The quantization quality gate is ``--compare_quant``: each split is answered
twice, with the loaded (bf16) weights and the model's KV cache, then with
``--quant_mode`` weights (``qwen3.quantize_params``) and an int8 KV cache;
the summary gets the quantized run's metrics, the accuracy delta and the
share of identical predictions. ``--num_samples -1`` answers whole splits in
file order, in chunks of 8 batches (a soak; ``--compare_quant`` is ignored
there). :func:`evaluate` is the loop over the splits, for callers that hold
the params already.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..data.dataset import DatasetConfig, MultiViewJsonDataset
from ..data.tokenizer import IMAGE_TOKEN, load_tokenizer
from ..inference.batching import max_prompt_len
from ..inference.qa import build_stage, load_model, pick_unique_scene_samples, run_inference
from ..models import qwen3

DEFAULT_GLOBS = {
    "sqa3d": "data/processed/sqa3d/test_split.jsonl",
    "scanqa": "data/processed/scanqa/test_split.jsonl",
    "arkit": "data/processed/arkit_synth/test.json",
}


def compute_metrics(records: List[Dict]) -> Dict[str, float]:
    exact = partial = 0
    total = len(records)
    for rec in records:
        pred = rec["prediction"]
        ref = rec["reference"]
        if isinstance(ref, dict):
            pred_lower = pred.lower().strip()
            if "action" in ref and ref["action"] in pred_lower:
                partial += 1
            try:
                if json.loads(pred) == ref:
                    exact += 1
            except Exception:
                pass
        else:
            p = pred.lower().strip()
            r = str(ref).lower().strip()
            if p == r:
                exact += 1
            elif r in p or p in r:
                partial += 1
    return {
        "total": total,
        "exact_match": exact,
        "partial_match": partial,
        "accuracy": exact / total * 100 if total else 0.0,
        "partial_accuracy": (exact + partial) / total * 100 if total else 0.0,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Quick baseline evaluation (PyTorch/CUDA port).")
    ap.add_argument("--config", default="configs/stage1_3d.yaml")
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--num_samples", type=int, default=50,
                    help="unique-scene samples a split; < 0 = the whole split in file order (soak)")
    ap.add_argument("--max_new_tokens", type=int, default=32)
    ap.add_argument("--output_dir", default="outputs/qa/baseline_eval")
    ap.add_argument("--datasets", nargs="+", default=["sqa3d", "scanqa", "arkit"])
    ap.add_argument("--glob", action="append", default=None, help="name=glob override, repeatable")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mock_vision", action="store_true")
    ap.add_argument("--compare_quant", action="store_true",
                    help="answer each split twice — loaded weights vs quantized weights + int8 KV — and report "
                         "the accuracy delta and the prediction agreement (the quantization quality gate)")
    ap.add_argument("--quant_mode", choices=["w8", "w8a8", "w4"], default="w8",
                    help="the quantized serving mode --compare_quant measures")
    ap.add_argument("--random_full", action="store_true",
                    help="the full-size model at random init when no checkpoint is given (a systems soak: "
                         "predictions are noise; without it and without a checkpoint the tiny mock model runs)")
    ap.add_argument("--serve_quant", choices=["none", "w8", "w8a8"], default="none",
                    help="quantize the text weights once after load (in place) and decode with an int8 KV cache")
    ap.add_argument("--device", default="cuda")
    return ap


def _soak(params, stage, tokenizer, dataset, path: Path, args, kv_dtype) -> List[Dict]:
    """The whole split in file order, 8 batches a chunk (so the decoded
    views of a full split never sit in host memory together)."""
    n = len(dataset)
    metas = [dataset.meta(i) for i in range(n)]
    pad = max_prompt_len(tokenizer, [f"{m.get('question') or m.get('instruction') or ''}\n{IMAGE_TOKEN}\n"
                                     for m in metas])
    records: List[Dict] = []
    mega = 8 * args.batch_size
    t0 = time.time()
    for s0 in range(0, n, mega):
        chunk = [dataset[i] for i in range(s0, min(s0 + mega, n))]
        records += run_inference(params, stage, tokenizer, chunk, max_new_tokens=args.max_new_tokens,
                                 batch_size=args.batch_size, output_path=path, verbose=False, pad_to_len=pad,
                                 append=s0 > 0, index_base=s0, kv_dtype=kv_dtype, device=args.device)
        dt = time.time() - t0
        print(f"  soak {path.stem}: {len(records)}/{n} ({len(records) / max(dt, 1e-9):.2f} samples/s, {dt:.0f}s)",
              flush=True)
    return records


def evaluate(params, stage, tokenizer, args, base: Optional[Dict[str, List[Dict]]] = None
             ) -> Tuple[Dict[str, Dict], Dict[str, List[Dict]]]:
    """Answer and score each split of ``args.datasets`` (``parser``'s
    fields) with ``params`` on ``args.device``; with ``args.compare_quant``
    also with ``args.quant_mode`` weights and an int8 KV cache. ``base``:
    the records of an earlier pass of the loaded weights over the same
    samples, used instead of answering them again (one bf16 pass compared
    with several modes). Writes the records' JSONL and
    ``baseline_summary.json`` under ``args.output_dir``; returns (summary,
    the loaded weights' records by split)."""
    globs = dict(DEFAULT_GLOBS)
    for ov in args.glob or []:
        name, pattern = ov.split("=", 1)
        globs[name] = pattern
    serve_kv = "int8" if args.serve_quant != "none" else None
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary: Dict[str, Dict] = {}
    answered: Dict[str, List[Dict]] = {}
    for name in args.datasets:
        try:
            dataset = MultiViewJsonDataset(DatasetConfig(
                path_glob=globs[name], num_views=stage.data.num_views, image_size=stage.data.image_size,
                task=name, root=args.data_root))
        except FileNotFoundError as e:
            print(f"skipping {name}: {e}")
            continue
        samples = None
        if args.num_samples < 0:
            records = _soak(params, stage, tokenizer, dataset, out_dir / f"{name}_baseline.jsonl", args, serve_kv)
        else:
            samples = [dataset[i] for i in pick_unique_scene_samples(dataset, args.num_samples, args.seed)]
            records = base[name] if base is not None else run_inference(
                params, stage, tokenizer, samples, max_new_tokens=args.max_new_tokens,
                batch_size=args.batch_size, output_path=out_dir / f"{name}_baseline.jsonl", verbose=False,
                kv_dtype=serve_kv, device=args.device)
        answered[name] = records
        metrics = compute_metrics(records)
        summary[name] = metrics
        print(f"{name}: {metrics['exact_match']}/{metrics['total']} exact ({metrics['accuracy']:.1f}%), "
              f"partial_accuracy {metrics['partial_accuracy']:.1f}%", flush=True)
        if args.compare_quant and samples is None:
            print("--compare_quant ignored in full-split soak mode (use the unique-scene protocol for the "
                  "quality gate)")
        elif args.compare_quant:
            mode = args.quant_mode
            q_records = run_inference(
                params, stage, tokenizer, samples, max_new_tokens=args.max_new_tokens,
                batch_size=args.batch_size, output_path=out_dir / f"{name}_baseline_{mode}.jsonl",
                verbose=False, quantize=True, kv_dtype="int8", quant_mode=mode, device=args.device)
            q_metrics = compute_metrics(q_records)
            agree = sum(r["prediction"] == q["prediction"] for r, q in zip(records, q_records)) / max(len(records), 1)
            summary[name][f"quantized_{mode}_int8kv"] = q_metrics
            summary[name]["em_delta_quantized"] = q_metrics["accuracy"] - metrics["accuracy"]
            summary[name]["prediction_agreement"] = round(agree, 4)
            print(f"{name} [{mode.upper()}+int8kv]: {q_metrics['exact_match']}/{q_metrics['total']} exact "
                  f"(Δaccuracy {summary[name]['em_delta_quantized']:+.1f}pp, prediction agreement {agree:.0%})",
                  flush=True)
    (out_dir / "baseline_summary.json").write_text(json.dumps(summary, indent=2))
    print(f"summary → {out_dir / 'baseline_summary.json'}")
    return summary, answered


def main(argv=None) -> Dict[str, Dict]:
    args = parser().parse_args(argv)
    if args.serve_quant != "none" and args.compare_quant:
        raise SystemExit("--serve_quant and --compare_quant are exclusive (the compare path quantizes per split)")
    stage = build_stage(args)
    tokenizer = load_tokenizer(None if args.tiny else stage.tokenizer_path or stage.text_model_name)
    params = load_model(stage, args.checkpoint_dir, device=args.device)
    if args.serve_quant != "none":
        # in place: each bf16 matrix is released as its int8 copy appears
        params = dict(params, text=qwen3.quantize_params(params["text"], mode=args.serve_quant))
    summary, _ = evaluate(params, stage, tokenizer, args)
    return summary


if __name__ == "__main__":
    main()
