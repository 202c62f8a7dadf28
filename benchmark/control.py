"""The readings that set a training cell's limits from above: the control and
the faults, at the cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--device cuda]

For each seed it makes the cell's inputs (``drivers/train.make_batches``),
follows the cell's micro steps with the float32 reference, then puts in the
program's place (a) the control — the same reference in float8 (operands
e4m3, gradients e5m2, a scale a tensor, as float8 training recipes run),
the step below the bfloat16 the configuration states, its W8A8 tower's
activations in int4, the step below int8 — and (b) the fault "half of the batch left out, the
mean taken over the rest" (the reference on the first half of each batch's
rows), and prints the training numbers of each against the float32 run,
with the leaf behind each leaf-wise gap. The fault "a step that returns its
state unchanged" reads 1 by ``update_gap``'s measure (no leaf moves where
the reference's move) and needs no run. The benchmark's own runs never run
this; ``benchmark/tests`` keeps it at the tiny sizes.

For a QA cell (:func:`qa_readings`) it answers one batch as the window does
and reads, at each position of the checked answers, the gap of the served
token and of the token the float8 reference puts first, both in the
float32 reference.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import torch

from . import compare, manifest
from .drivers import train as drv
from .reference import model as ref_model
from .reference import train as ref_train


def readings(cell: dict, seed: int, device) -> Dict[str, dict]:
    """{"control": numbers, "half_batch": numbers, ...} of one seed."""
    cfg, spec = cell["config"], cell["spec"]
    rows = spec.get("rows", cfg["batch_size_per_gpu"])
    n = cfg["grad_accum"]
    batches = drv.make_batches(cfg, rows, n, seed, device)
    seeds = [drv.gen_seed(seed, i) for i in range(n)]
    start = drv.start_update(cfg)
    state = ref_train.quantized(cfg, seed, device)
    cache: Dict[int, torch.Tensor] = {}
    kw = dict(state=state, start_update=start)
    ref = ref_train.follow(cfg, seed, batches, seeds, device, ref_model.Prec(), tokens_cache=cache, **kw)
    out = {}
    for name, prec, half, tokens in (("control", ref_model.Prec(fp8=True), None, None),
                                     ("half_batch", ref_model.Prec(), rows // 2, cache)):
        got = ref_train.follow(cfg, seed, batches, seeds, device, prec, rows=half, tokens_cache=tokens, **kw)
        nums = {k: v for k, v, _ in compare.training(got, ref, spec["limits"], device)}
        out[name] = dict(compare.report(got, ref), **nums, loss_gap=compare.loss_gap(got, ref))
        del got
    return out


def qa_readings(cell: dict, seed: int, device, batches: int = 1) -> Dict[str, float]:
    """A QA cell's program and control readings of one seed: set-up, one
    batch answered as the window answers it, then the widest logit gap of
    the served tokens and of the tokens the float8 reference puts first."""
    from .drivers import qa
    from .trace import Recorder

    sess = qa.Session(cell, seed, device)
    sess.setup()
    for i in range(batches):
        sess.step(i, Recorder(False))
    sess.release()
    program, control = sess.gaps([ref_model.Prec(), ref_model.Prec(fp8=True)])
    return {"program": program, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    dev = torch.device(args.device)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        res = (qa_readings if cell["spec"]["driver"] == "qa" else readings)(cell, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
