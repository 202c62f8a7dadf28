"""The port's evals (``evals/baseline.py``, ``evals/iou3d.py``) against the
JAX package's: the metrics on the same records, and the baseline CLI's
summary (``--tiny --mock_vision --device cpu`` on the in-repo placeholder
test splits) with the keys JAX's CLI writes for ``--compare_quant``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vggt_qwen3_tpu.evals import baseline as jbaseline
from vggt_qwen3_tpu.evals import iou3d as jiou
from vggt_qwen3_tpu_torch.evals import baseline as pbaseline
from vggt_qwen3_tpu_torch.evals import iou3d as piou

REPO = Path(__file__).resolve().parents[1]


def test_compute_metrics_matches_jax():
    """String references (exact, substring either way, miss, case and
    spaces) and action dicts (parsed-JSON equality, the action substring,
    unparsable predictions): the same counts and percentages as JAX's."""
    action = {"action": "place", "scene": "s0", "center": [0, 1, 2]}
    records = [
        dict(prediction="Brown", reference="brown "),
        dict(prediction="the brown chair", reference="brown"),
        dict(prediction="on", reference="on the table"),
        dict(prediction="red", reference="blue"),
        dict(prediction=json.dumps(action), reference=action),
        dict(prediction='{"action": "place", "scene": "s1"', reference=action),
        dict(prediction="nothing", reference=action),
        dict(prediction="", reference="x"),
    ]
    for recs in (records, records[:3], []):
        assert pbaseline.compute_metrics(recs) == jbaseline.compute_metrics(recs)
    assert pbaseline.compute_metrics(records)["exact_match"] == 2


def test_iou3d_matches_jax(tmp_path, capsys):
    """IoU of random boxes (overlapping, disjoint, degenerate) and
    mAcc@IoU at three thresholds equal JAX's; the CLI prints it."""
    rng = np.random.default_rng(30)
    boxes = []
    for _ in range(40):
        lo = rng.uniform(-1, 1, 3)
        boxes.append({"min": lo.tolist(), "max": (lo + rng.uniform(0, 1.5, 3) * (rng.random() > 0.1)).tolist()})
    preds, refs = [{"box": b} for b in boxes[:20]], [{"box": b} for b in boxes[20:]]
    for a, b in zip(boxes[:20], boxes[20:]):
        assert piou.iou_3d(a, b) == jiou.iou_3d(a, b)
    unit = {"min": [0.0, 0.0, 0.0], "max": [1.0, 2.0, 3.0]}
    assert piou.iou_3d(unit, unit) == 1.0
    assert piou.iou_3d(unit, {"min": [2.0, 0.0, 0.0], "max": [3.0, 1.0, 1.0]}) == 0.0
    for t in (0.0, 0.1, 0.5):
        assert piou.macc_at_iou(preds, refs, t) == jiou.macc_at_iou(preds, refs, t)
    p, r = tmp_path / "p.jsonl", tmp_path / "r.jsonl"
    p.write_text("\n".join(json.dumps(x) for x in preds) + "\n")
    r.write_text("\n".join(json.dumps(x) for x in refs) + "\n")
    assert piou.load_boxes(p) == preds
    piou.main(["--predictions", str(p), "--references", str(r), "--iou-threshold", "0.1"])
    assert capsys.readouterr().out.strip() == f"mAcc@IoU0.1: {jiou.macc_at_iou(preds, refs, 0.1) * 100:.2f}%"


def test_baseline_compare_quant_summary_has_jax_keys(tmp_path, monkeypatch):
    """``--compare_quant --quant_mode w8a8`` on the tiny mock model: each
    split answered twice (the second time with W8A8 weights and an int8
    cache), the records' JSONL of both runs, and a summary whose keys are
    those of JAX's CLI run the same way."""
    flags = ["--tiny", "--mock_vision", "--compare_quant", "--quant_mode", "w8a8", "--num_samples", "3",
             "--max_new_tokens", "4", "--datasets", "sqa3d", "scanqa", "arkit"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "vggt_qwen3_tpu.evals.baseline", *flags,
                           "--output_dir", str(tmp_path / "jax")], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads((tmp_path / "jax" / "baseline_summary.json").read_text())

    monkeypatch.chdir(REPO)
    calls = []
    real = pbaseline.run_inference
    monkeypatch.setattr(pbaseline, "run_inference", lambda *a, **k: calls.append(k) or real(*a, **k))
    got = pbaseline.main([*flags, "--device", "cpu", "--output_dir", str(tmp_path / "port")])
    assert json.loads((tmp_path / "port" / "baseline_summary.json").read_text()) == got
    assert set(got) == set(ref) == {"sqa3d", "scanqa", "arkit"}
    for name in ref:
        assert set(got[name]) == set(ref[name])
        assert set(got[name]["quantized_w8a8_int8kv"]) == set(ref[name]["quantized_w8a8_int8kv"])
        assert got[name]["total"] == ref[name]["total"] == 3
        assert 0.0 <= got[name]["prediction_agreement"] <= 1.0
        for suffix in ("", "_w8a8"):
            lines = (tmp_path / "port" / f"{name}_baseline{suffix}.jsonl").read_text().splitlines()
            assert len(lines) == 3
    assert [(k.get("quantize", False), k.get("quant_mode"), k.get("kv_dtype")) for k in calls] == \
        [(False, None, None), (True, "w8a8", "int8")] * 3


def test_baseline_soak_with_serve_quant(tmp_path, monkeypatch):
    """``--num_samples -1`` answers the whole split in file order with
    ``--serve_quant w8a8`` weights (quantized once, int8 cache);
    ``--compare_quant`` beside ``--serve_quant`` is refused."""
    monkeypatch.chdir(REPO)
    got = pbaseline.main(["--tiny", "--mock_vision", "--device", "cpu", "--num_samples", "-1", "--batch_size", "3",
                          "--max_new_tokens", "3", "--serve_quant", "w8a8", "--datasets", "sqa3d",
                          "--output_dir", str(tmp_path)])
    rows = [json.loads(x) for x in (tmp_path / "sqa3d_baseline.jsonl").read_text().splitlines()]
    n = len((REPO / pbaseline.DEFAULT_GLOBS["sqa3d"]).read_text().splitlines())
    assert got["sqa3d"]["total"] == len(rows) == n and [r["index"] for r in rows] == list(range(n))
    with pytest.raises(SystemExit, match="exclusive"):
        pbaseline.main(["--tiny", "--mock_vision", "--device", "cpu", "--serve_quant", "w8", "--compare_quant"])
