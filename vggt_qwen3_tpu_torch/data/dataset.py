"""Multi-view JSON/JSONL record reader and the mixed-ratio multi-source
dataset (the port's own copy of ``vggt_qwen3_tpu/data/dataset.py``).

Records normalise to ``{images, geom_token, question, answer, task,
scene_id}``; image paths resolve with the ``data/raw`` fallback; images load
as RGB uint8 numpy arrays through PIL, imported only when an image is read.
JSONL is parsed with ``json``, so no native library is needed. Ragged view
counts pad to ``num_views`` by repeating the last view, as the JAX package
does (a known divergence from the upstream reference, kept for parity);
per-view geometry arrays follow the same truncate/pad policy.

:class:`MultiSourceDataset` keeps the reference's mix-ratio interleave with
its randomness: a ~100-slot schedule from the ratios, ``random.Random(0)``,
sampling with replacement; ``consume_rng`` advances that draw stream without
touching data, so a resumed loader reproduces the stream exactly.
"""

from __future__ import annotations

import glob as globlib
import json
import random
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

    def _normalize_geom(self, geom):
        """Per-view [V', k] arrays truncated or padded (last view repeated) to
        ``num_views``, as the views are; other values pass through."""
        if not isinstance(geom, dict):
            return geom
        V = self.config.num_views
        out = {}
        for key, val in geom.items():
            a = np.asarray(val, np.float32)
            if a.ndim == 2 and a.shape[0] != V:
                a = a[:V]
                if a.shape[0] and a.shape[0] < V:
                    a = np.concatenate([a, np.repeat(a[-1:], V - a.shape[0], axis=0)])
            out[key] = a
        return out

    def __getitem__(self, idx: int) -> Dict:
        sample = self._records[idx]
        loaded = [self._load_image(img) for img in sample["images"][: self.config.num_views]]
        while loaded and len(loaded) < self.config.num_views:
            loaded.append(loaded[-1])
        return {
            "images": loaded,
            "geom_token": self._normalize_geom(sample.get("geom_token")),
            "question": sample.get("question") or sample.get("instruction"),
            "answer": sample.get("answer") or sample.get("action_json"),
            "task": sample.get("task", self.config.task),
            "scene_id": sample.get("scene_id"),
        }


class MultiSourceDataset:
    """Mix-ratio interleave (reference semantics, including randomness)."""

    def __init__(self, datasets: Dict[str, MultiViewJsonDataset], mix_ratio: Dict[str, float]):
        self.datasets = datasets
        self.mix_ratio = mix_ratio
        self.order = self._build_schedule()
        self.total_length = sum(len(v) for v in datasets.values())
        self.random = random.Random(0)

    def _build_schedule(self) -> List[str]:
        total = sum(self.mix_ratio.values())
        schedule: List[str] = []
        for name, weight in self.mix_ratio.items():
            schedule.extend([name] * max(1, int(round(weight / total * 100))))
        return schedule

    def __len__(self) -> int:
        return self.total_length

    def __getitem__(self, idx: int) -> Dict:
        ds = self.datasets[self.order[idx % len(self.order)]]
        return ds[self.random.randint(0, len(ds) - 1)]

    def consume_rng(self, idx: int) -> None:
        """Advance the sampling rng exactly as ``self[idx]`` would, without
        touching data."""
        ds = self.datasets[self.order[idx % len(self.order)]]
        self.random.randint(0, len(ds) - 1)
