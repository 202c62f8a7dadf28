"""Time the training phases of ``chip_smoke.py`` for one tree of the repo, on the card.

    python3 scripts/time_training_phases.py [--package_root DIR] [--seed 0]

Imports ``chip_smoke.py`` and the port from DIR (default: this checkout;
another tree, such as a parent commit unpacked with ``git archive``, compares
two versions in one call: parent, change, change, parent), builds the
kernels, then runs that tree's card-vs-CPU training check
(``reference_check_train``) and its full-width training path
(``train_path``), and prints one JSON line with the seconds of each, the
card's name and its power limit.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package_root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.package_root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("time_training_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from vggt_qwen3_tpu_torch.ops import kernel_build as kb

    assert Path(cs.__file__).resolve().parent == root, cs.__file__
    kb.build(sorted(p.stem for p in kb.CSRC.glob("*.cu")))
    t0 = time.perf_counter()
    cs.reference_check_train(args.seed)
    t1 = time.perf_counter()
    cs.train_path(argparse.Namespace(seed=args.seed, max_new_tokens=32))
    t2 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": str(root), "reference_check_train_s": round(t1 - t0, 1),
                      "train_path_s": round(t2 - t1, 1), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
