"""Training monitor CLI (the port's copy of ``vggt_qwen3_tpu/utils/monitor.py``).

Reads a training run's ``metrics.jsonl`` (``utils/logging.MetricLogger``), or
the newest TensorBoard event file under a logdir when there is no JSONL, and
prints a progress bar, loss statistics, both learning rates, speed, the
gradient norm and an ASCII loss trend; ``--watch`` refreshes it every
``--interval`` seconds.

    python -m vggt_qwen3_tpu_torch.utils.monitor --logdir ckpts/stage1 [--watch] [--interval 30]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Tuple

Series = Dict[str, List[Tuple[int, float]]]


def load_from_jsonl(path: Path) -> Series:
    metrics: Series = {}
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        step = int(rec.pop("step", 0))
        for key, val in rec.items():
            metrics.setdefault(f"train/{key}", []).append((step, float(val)))
    return metrics


def load_from_tensorboard(logdir: Path) -> Series:
    from tensorboard.backend.event_processing import event_accumulator

    event_files = list(logdir.rglob("events.out.tfevents.*"))
    if not event_files:
        return {}
    newest = max(event_files, key=lambda p: p.stat().st_mtime)
    ea = event_accumulator.EventAccumulator(str(newest))
    ea.Reload()
    metrics: Series = {}
    for tag in ea.Tags()["scalars"]:
        metrics[tag] = [(e.step, e.value) for e in ea.Scalars(tag)]
    return metrics


def load_metrics(logdir: Path) -> Series:
    jsonl = logdir / "metrics.jsonl"
    if jsonl.exists():
        return load_from_jsonl(jsonl)
    if logdir.is_file() and logdir.suffix == ".jsonl":
        return load_from_jsonl(logdir)
    return load_from_tensorboard(logdir)


def render(metrics: Series, *, clear: bool = True) -> None:
    if clear:
        os.system("clear" if os.name != "nt" else "cls")
    print("\n" + "=" * 80)
    print("📊 TRAINING MONITOR".center(80))
    print("=" * 80)
    print(f"🕐 Updated: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}")

    loss = metrics.get("train/loss", [])
    if not loss:
        print("\n⚠️  No loss data found yet. Training may just be starting...")
        return
    step, cur = loss[-1]
    print(f"\n   Step: {step:,}")

    progress = metrics.get("train/progress_pct", [])
    if progress:
        pct = progress[-1][1]
        filled = int(50 * pct / 100)
        print(f"   Progress: [{'█' * filled}{'░' * (50 - filled)}] {pct:.1f}%")

    print(f"\n📉 Loss: current {cur:.4f}", end="")
    if len(loss) >= 10:
        recent = [v for _, v in loss[-10:]]
        print(
            f" | recent avg {sum(recent)/len(recent):.4f}"
            f" | min {min(v for _, v in loss):.4f}"
            f" | max {max(v for _, v in loss):.4f}",
            end="",
        )
    print()

    base = metrics.get("train/learning_rate_base", [])
    proj = metrics.get("train/learning_rate_proj", [])
    if base:
        line = f"📚 LR: base {base[-1][1]:.2e}"
        if proj:
            line += f" | projector {proj[-1][1]:.2e}"
        print(line)

    speed = metrics.get("train/steps_per_sec", [])
    if speed:
        print(f"⏱️  Speed: {speed[-1][1]:.2f} steps/s")

    grad = metrics.get("train/grad_norm", [])
    if grad:
        print(f"∇  Grad norm: {grad[-1][1]:.3f}")

    if len(loss) >= 20:
        vals = [v for _, v in loss[-20:]]
        lo, hi = min(vals), max(vals)
        rng = max(hi - lo, 1e-9)
        print("\n📊 Loss trend (last 20 logged steps):")
        for i in range(8, 0, -1):
            thresh = lo + rng * i / 8
            print("   " + "".join("█" if v >= thresh else " " for v in vals))
        print(f"   {lo:.3f}{' ' * 10}{hi:.3f}")
    print("=" * 80)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Monitor training progress.")
    ap.add_argument("--logdir", required=True, help="output_dir of a training run (or metrics.jsonl / TB logdir)")
    ap.add_argument("--watch", action="store_true")
    ap.add_argument("--interval", type=int, default=30)
    ap.add_argument("--no-clear", action="store_true")
    args = ap.parse_args(argv)

    logdir = Path(args.logdir)
    while True:
        render(load_metrics(logdir), clear=not args.no_clear)
        if not args.watch:
            break
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
