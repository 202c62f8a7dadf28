"""Exact-match QA evaluation — reference ``src/eval/eval_3dqa.py``.

EM = case-insensitive stripped string equality over aligned prediction /
reference arrays (``eval_3dqa.py:30-38``).

    python -m vggt_qwen3_tpu_torch.evals.em --predictions preds.json --references refs.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List


def load_json_array(path: Path) -> List[dict]:
    data = json.loads(Path(path).read_text())
    if isinstance(data, dict):
        data = data.get("data") or data.get("samples") or []
    if not isinstance(data, list):
        raise ValueError(f"expected a JSON array in {path}")
    return data


def exact_match_accuracy(preds: List[dict], refs: List[dict], key: str = "answer") -> float:
    correct = sum(
        int(str(p[key]).strip().lower() == str(r[key]).strip().lower())
        for p, r in zip(preds, refs)
    )
    return correct / max(len(refs), 1)


def main() -> None:
    ap = argparse.ArgumentParser(description="Evaluate 3D QA datasets (EM).")
    ap.add_argument("--predictions", type=Path, required=True)
    ap.add_argument("--references", type=Path, required=True)
    args = ap.parse_args()
    preds = load_json_array(args.predictions)
    refs = load_json_array(args.references)
    acc = exact_match_accuracy(preds, refs)
    correct = round(acc * max(len(refs), 1))
    print(f"Accuracy: {acc * 100:.2f}% ({correct}/{len(refs)})")


if __name__ == "__main__":
    main()
