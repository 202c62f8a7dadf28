"""Training metrics: console lines, TensorBoard events and a JSONL file (the
port's own copy of ``vggt_qwen3_tpu/utils/logging.py``).

The JSONL records carry the JAX logger's keys (``loss``, ``grad_norm``,
``learning_rate_base``, ``learning_rate_proj``, ``loader_stall_s``,
``steps_per_sec``, ``progress_pct``); the console line has its format. As in
JAX, each record also goes to ``torch.utils.tensorboard.SummaryWriter`` under
``<output_dir>/logs/<run_name>`` with the tags ``train/<key>``, flushed at
every record, where the ``tensorboard`` package is installed (without it the
logger writes JSONL and console lines only; ``tensorboard`` is None).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, output_dir: str | Path, run_name: str = "roomplan") -> None:
        self.output_dir = Path(output_dir)
        self.run_name = run_name
        logdir = self.output_dir / "logs" / run_name
        logdir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.output_dir / "metrics.jsonl"
        self.tensorboard = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the tensorboard package is not installed
            pass
        else:
            self.tensorboard = SummaryWriter(log_dir=str(logdir))
        self.start_time = time.time()

    def log(self, step: int, metrics: Dict[str, float], *, max_steps: Optional[int] = None) -> None:
        elapsed = time.time() - self.start_time
        record = dict(metrics)
        record["steps_per_sec"] = (step + 1) / elapsed if elapsed > 0 else 0.0
        if max_steps:
            record["progress_pct"] = 100.0 * (step + 1) / max_steps
        if self.tensorboard is not None:
            for k, v in record.items():
                self.tensorboard.add_scalar(f"train/{k}", float(v), step)
            self.tensorboard.flush()
        with self.jsonl_path.open("a", encoding="utf-8") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in record.items()}}) + "\n")

    def console(self, step: int, max_steps: int, loss: float, base_lr: float, proj_lr: float) -> None:
        elapsed = time.time() - self.start_time
        sps = (step + 1) / elapsed if elapsed > 0 else 0.0
        eta_h = ((max_steps - step - 1) / sps / 3600.0) if sps > 0 else 0.0
        print(
            f"Step {step:5d}/{max_steps} | Loss: {loss:.4f} | "
            f"LR: {base_lr:.2e}/{proj_lr:.2e} | Speed: {sps:.2f} steps/s | "
            f"ETA: {eta_h:.1f}h",
            flush=True,
        )

    def close(self) -> None:
        if self.tensorboard is not None:
            self.tensorboard.close()
