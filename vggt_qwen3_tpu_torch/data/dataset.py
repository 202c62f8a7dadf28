"""Multi-view JSON/JSONL record reader (the record-reading part of
``vggt_qwen3_tpu/data/dataset.py``).

Records normalise to ``{images, geom_token, question, answer, task,
scene_id}``; image paths resolve with the ``data/raw`` fallback; images load
as RGB uint8 numpy arrays through PIL, imported only when an image is read.
JSONL is parsed with ``json``, so no native library is needed. Ragged view
counts pad to ``num_views`` by repeating the last view, as the JAX package
does (a known divergence from the upstream reference, kept for parity).
"""

from __future__ import annotations

import glob as globlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class DatasetConfig:
    path_glob: str
    num_views: int
    image_size: int
    task: str
    root: Optional[str] = None  # base dir for relative paths (default: cwd)


def read_records(path: Path) -> List[Dict]:
    """All records of one .jsonl or .json file."""
    text = Path(path).read_text(encoding="utf-8")
    if Path(path).suffix == ".jsonl":
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    records = json.loads(text)
    if isinstance(records, dict):
        records = records.get("data") or records.get("samples") or []
    if not isinstance(records, list):
        raise ValueError(f"expected a JSON array in {path}")
    return records


def load_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


class MultiViewJsonDataset:
    def __init__(self, config: DatasetConfig) -> None:
        self.config = config
        root = Path(config.root) if config.root else Path()
        pattern_path = Path(config.path_glob)
        if pattern_path.is_file():
            files = [pattern_path]
        elif pattern_path.is_absolute():
            files = sorted(Path(p) for p in globlib.glob(config.path_glob))
        else:
            files = sorted(root.glob(config.path_glob))
        self.files = files
        self._records: List[Dict] = [r for f in files for r in read_records(f)]
        if not self._records:
            raise FileNotFoundError(f"no samples found for pattern {config.path_glob}")

    def __len__(self) -> int:
        return len(self._records)

    def meta(self, idx: int) -> Dict:
        """Raw record metadata without loading images."""
        return self._records[idx]

    def _load_image(self, rel_path: str) -> np.ndarray:
        root = Path(self.config.root) if self.config.root else Path()
        p = Path(rel_path)
        candidates = [p] if p.is_absolute() else [root / p, root / "data" / "raw" / p]
        for cand in candidates:
            if cand.exists():
                return load_rgb(str(cand))
        raise FileNotFoundError(f"image not found: tried {', '.join(map(str, candidates))}")

    def __getitem__(self, idx: int) -> Dict:
        sample = self._records[idx]
        loaded = [self._load_image(img) for img in sample["images"][: self.config.num_views]]
        while loaded and len(loaded) < self.config.num_views:
            loaded.append(loaded[-1])
        return {
            "images": loaded,
            "geom_token": sample.get("geom_token"),
            "question": sample.get("question") or sample.get("instruction"),
            "answer": sample.get("answer") or sample.get("action_json"),
            "task": sample.get("task", self.config.task),
            "scene_id": sample.get("scene_id"),
        }
