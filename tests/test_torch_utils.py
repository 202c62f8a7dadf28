"""The port's training utilities against the JAX package's, on the CPU: the
metric logger's TensorBoard events and JSONL (read back by the port's monitor
into the Series JAX's monitor reads from the same files), the monitor CLI,
``check_finite`` / ``tree_stats`` / ``enable_nan_checks`` and the profiler
trace."""

import json

import numpy as np
import pytest
import torch

from vggt_qwen3_tpu.utils import debug as jdebug
from vggt_qwen3_tpu.utils import monitor as jmonitor
from vggt_qwen3_tpu_torch.utils import debug, monitor, profiling
from vggt_qwen3_tpu_torch.utils.logging import MetricLogger


def _log_run(out, steps=25):
    logger = MetricLogger(out, run_name="run")
    for step in range(steps):
        logger.log(step, {"loss": 2.0 / (step + 1), "grad_norm": 0.5 + step, "learning_rate_base": 1e-5 * step,
                          "learning_rate_proj": 1e-4 * step, "loader_stall_s": 0.0}, max_steps=steps)
    logger.close()
    return logger


def test_logger_events_and_jsonl_read_back_as_jax_reads_them(tmp_path):
    logger = _log_run(tmp_path)
    assert logger.tensorboard is not None
    events = list((tmp_path / "logs" / "run").glob("events.out.tfevents.*"))
    assert len(events) == 1
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == list(range(25))
    assert set(lines[0]) == {"step", "loss", "grad_norm", "learning_rate_base", "learning_rate_proj",
                             "loader_stall_s", "steps_per_sec", "progress_pct"}
    ours_jsonl = monitor.load_from_jsonl(tmp_path / "metrics.jsonl")
    assert ours_jsonl == jmonitor.load_from_jsonl(tmp_path / "metrics.jsonl")
    assert monitor.load_metrics(tmp_path) == ours_jsonl  # the JSONL is read first
    ours_tb = monitor.load_from_tensorboard(tmp_path / "logs")
    assert ours_tb == jmonitor.load_from_tensorboard(tmp_path / "logs")
    assert set(ours_tb) == set(ours_jsonl)
    for tag, series in ours_tb.items():  # events hold f32 scalars
        assert [s for s, _ in series] == [s for s, _ in ours_jsonl[tag]], tag
        np.testing.assert_allclose([v for _, v in series], [v for _, v in ours_jsonl[tag]], rtol=1e-6, err_msg=tag)
    assert monitor.load_metrics(tmp_path / "logs") == ours_tb  # no JSONL: the events


def test_monitor_cli_renders_a_run(tmp_path, capsys):
    _log_run(tmp_path)
    monitor.main(["--logdir", str(tmp_path), "--no-clear"])
    out = capsys.readouterr().out
    assert "Step: 24" in out and "Progress:" in out and "100.0%" in out and "Loss trend" in out
    jmonitor.render(jmonitor.load_metrics(tmp_path), clear=False)
    theirs = capsys.readouterr().out
    drop = lambda s: [x for x in s.splitlines() if "Updated" not in x]  # noqa: E731
    assert drop(out) == drop(theirs)


def _tree():
    rng = np.random.default_rng(0)
    return {"text": {"layers": {"wq": rng.standard_normal((2, 4, 4)).astype(np.float32),
                                "ids": np.arange(6, dtype=np.int32)},
                     "norm": np.ones(4, np.float32)},
            "projector": {"w": rng.standard_normal((3, 5)).astype(np.float32)}}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_check_finite_names_the_bad_leaf():
    tree = _torch(_tree())
    debug.check_finite(tree)
    tree["text"]["layers"]["wq"][1, 2, 3] = float("nan")
    tree["projector"]["w"][0, 0] = float("inf")
    with pytest.raises(FloatingPointError, match=r"params: non-finite values in \['text/layers/wq', 'projector/w'\]"):
        debug.check_finite(tree, "params")
    bad = _tree()
    bad["text"]["layers"]["wq"][1, 2, 3] = np.nan
    with pytest.raises(FloatingPointError):  # JAX's flags the same leaf
        jdebug.check_finite(bad)


def test_tree_stats_match_jax():
    tree = _tree()
    ours = debug.tree_stats(_torch(tree))
    theirs = jdebug.tree_stats(tree)
    assert list(ours) == ["text/layers/wq", "text/layers/ids", "text/norm", "projector/w"]
    by_value = sorted(theirs.values(), key=lambda s: (s["shape"], s["mean"]))
    assert sorted(ours.values(), key=lambda s: (s["shape"], s["mean"])) == by_value


def test_enable_nan_checks_raises_in_the_backward():
    try:
        debug.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0, 1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0 - 1).sum().backward()  # NaN in the forward goes through; its backward raises
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_profiling_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(tmp_path / "prof"):
        with profiling.annotate("matmul_range"):
            (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "matmul_range" in names and any("mm" in str(n) for n in names)
    with pytest.raises(NotImplementedError, match="no trace server"):
        profiling.start_server()
