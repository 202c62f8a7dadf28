"""3D grounding evaluation (the port's own copy of
``vggt_qwen3_tpu/evals/iou3d.py``; reference ``src/eval/eval_ref3d.py``).

Axis-aligned 3D IoU from ``{min, max}`` corner boxes; mAcc@IoU≥threshold
(default 0.5) over aligned prediction/reference JSONL (``eval_ref3d.py:22-44``).

    python -m vggt_qwen3_tpu_torch.evals.iou3d --predictions p.jsonl --references r.jsonl
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List


def iou_3d(box_a: Dict, box_b: Dict) -> float:
    def volume(box):
        sizes = [max(0.0, box["max"][i] - box["min"][i]) for i in range(3)]
        return sizes[0] * sizes[1] * sizes[2]

    inter = {
        "min": [max(box_a["min"][i], box_b["min"][i]) for i in range(3)],
        "max": [min(box_a["max"][i], box_b["max"][i]) for i in range(3)],
    }
    inter_vol = volume(inter)
    union = volume(box_a) + volume(box_b) - inter_vol
    return inter_vol / max(union, 1e-6)


def load_boxes(path: Path) -> List[Dict]:
    return [json.loads(line) for line in Path(path).read_text().splitlines() if line]


def macc_at_iou(preds: List[Dict], refs: List[Dict], threshold: float = 0.5) -> float:
    correct = sum(int(iou_3d(p["box"], r["box"]) >= threshold) for p, r in zip(preds, refs))
    return correct / max(len(refs), 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="mAcc@IoU for referential grounding.")
    ap.add_argument("--predictions", type=Path, required=True)
    ap.add_argument("--references", type=Path, required=True)
    ap.add_argument("--iou-threshold", type=float, default=0.5)
    args = ap.parse_args(argv)
    metric = macc_at_iou(load_boxes(args.predictions), load_boxes(args.references), args.iou_threshold)
    print(f"mAcc@IoU{args.iou_threshold}: {metric * 100:.2f}%")


if __name__ == "__main__":
    main()
