"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run makes its weights and inputs from
``--seed`` on the card, warms up the cell's own shapes (the set-up, timed
whole as ``setup_s``), runs the cell's step back to back until ``--seconds``
have passed (the window: every step that started in it is finished and
counted), reads the peak of device memory, then frees the program's state
and checks what the program produced against the plain reference
(``benchmark/reference``). It prints the compared numbers with their limits
as the last lines of standard error, and one JSON object as the last line
of standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones,
read from a device trace of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and when JAX, Flax or the JAX package was loaded
in this process. ``BENCH_RUN`` in the environment is not read.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

from benchmark import T0

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"  # fixed, inside the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "vggt_qwen3_tpu")


def log(what: str) -> None:
    """A progress line on standard error, with the seconds since the start."""
    print(f"[{time.perf_counter() - T0:8.2f} s] {what}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that a run must not load, each
    compared whole (the part before the first dot): ``vggt_qwen3_tpu_torch``
    is not ``vggt_qwen3_tpu``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _environment() -> None:
    """Caches at fixed paths inside the checkout; libraries kept from JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the stage-2 cell's float32 attention scores come and go in 8 GiB pieces
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def _add(total: dict, part: dict) -> None:
    for k, v in part.items():
        if isinstance(v, dict):
            _add(total.setdefault(k, {}), v)
        else:
            total[k] = total.get(k, 0) + v


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", adjust=None) -> dict:
    """One run of cell ``name``; the result object (``adjust``, for the CPU
    tests only: a function given the cell dict before the run, to shrink it)."""
    import torch

    from benchmark import manifest, program, trace as tr

    bench = manifest.load()
    cell = manifest.cell(name, bench)
    if adjust is not None:
        adjust(cell)
    drv = manifest.driver(cell["spec"]["driver"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sess = drv.Session(cell, seed, dev)
    log(f"set-up of {name}, seed {seed}")
    sess.setup()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T0

    log(f"set-up done; the window ({seconds} s)")
    rec = tr.Recorder(trace and cuda)
    before = program.counters()
    prof = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    work: Dict[str, object] = {}
    steps = 0
    start = time.perf_counter()
    while True:
        _add(work, sess.step(steps, rec))
        if cuda:
            torch.cuda.synchronize(dev)
        steps += 1
        window_s = time.perf_counter() - start
        if window_s >= seconds:
            break
    if prof is not None:
        prof.__exit__(None, None, None)
    counters = {k: v - before[k] for k, v in program.counters().items()}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    card = _power_limit() if cuda else None

    log(f"window done: {steps} steps in {window_s:.3f} s")
    records = tr.device_records(prof) if prof is not None else []
    # what a per-layer reader reads: the window's work and time, the spans, the counters, the device records
    r = SimpleNamespace(cell=cell, cfg=cell["config"], window_s=window_s, steps=steps, work=work, spans=rec.spans,
                        counters=counters, records=records, busy_s=tr.busy_s(tr.work(records)) if records else 0.0,
                        card=card)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in manifest.metrics_of(bench, name, "per_layer"):
            value = manifest.reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(drv.end_to_end(work, window_s), peak_mem_gib=peak / 2**30, setup_s=setup_s)
        for m in manifest.metrics_of(bench, name, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    result = {"correct": False, "attempted": int(work.get("attempted", steps)), "failed": int(work.get("failed", 0)),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and cuda:
        result["device"].update(busy_s=r.busy_s, window_s=window_s)
        result["breakdown"] = tr.breakdown(records, rec.phases)
    del records, r, prof

    sess.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = sess.check()
    result["correct"] = bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    result["card"] = card
    result["setup_s"] = setup_s
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once on this machine's card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from benchmark import manifest

    chips = [w for w in manifest.load()["workloads"] if w["name"] == args.workload]
    need = chips[0]["chips"] if chips else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: this process loaded {bad}: the run measures the PyTorch port alone", file=sys.stderr)
        return 3
    card, setup_s = result.pop("card"), result.pop("setup_s")
    print(f"card: {card}; setup {setup_s:.3f} s", file=sys.stderr)
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
