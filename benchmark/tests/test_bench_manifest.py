"""BENCHMARK.json and the files it names: names, units and limits by the
contract's rules, every driver and reader found by name, a new cell and a
new metric found as new files alone, and the import check."""

import json
import shutil
from types import SimpleNamespace

import pytest

from benchmark import manifest, run


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_names_units_and_files_follow_the_rules(bench):
    assert manifest.problems(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json" and c["source"].startswith("https://")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert all(cell in [w["name"] for w in bench["workloads"]] for cell in m.get("workloads", []))


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(bench, w["name"], "per_layer")


def test_every_driver_and_reader_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"], bench)
        drv = manifest.driver(cell["spec"]["driver"])
        assert callable(drv.end_to_end) and hasattr(drv, "Session")
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_a_new_cell_and_metric_are_new_files_only(bench, tmp_path):
    here = tmp_path / "benchmark"
    for sub in ("configs", "workloads", "metrics", "drivers"):
        shutil.copytree(manifest.HERE / sub, here / sub)
    spec = json.loads((here / "workloads" / "stage1-train-qlora.json").read_text())
    spec["traffic"] = "qlora-recipe-b3"
    spec["rows"] = 3
    (here / "workloads" / "stage1-train-b3.json").write_text(json.dumps(spec))
    (here / "metrics" / "steps.train.py").write_text("def read(r):\n    return float(r.steps)\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "stage1-train-b3", "config": "vggt1b-qwen3-4b-stage1",
                               "traffic": "qlora-recipe-b3", "chips": 1, "why": "three rows"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "train_tokens_per_s", "workloads": ["stage1-train-b3"]})
    assert manifest.problems(bench, here) == []
    cell = manifest.cell("stage1-train-b3", bench, here)
    assert cell["spec"]["rows"] == 3 and cell["config"]["name"] == "vggt1b-qwen3-4b-stage1"
    assert [m["name"] for m in manifest.metrics_of(bench, "stage1-train-b3", "per_layer")] == ["steps.train"]
    assert manifest.reader("steps.train", here)(SimpleNamespace(steps=7)) == 7.0


def test_the_import_check_compares_whole_top_level_names():
    assert run.forbidden_modules({"vggt_qwen3_tpu_torch", "vggt_qwen3_tpu_torch.ops.quant", "numpy"}) == []
    assert run.forbidden_modules({"jax.numpy", "numpy"}) == ["jax"]
    assert run.forbidden_modules({"vggt_qwen3_tpu.models.vlm", "jaxlib", "flax.linen"}) == [
        "flax", "jaxlib", "vggt_qwen3_tpu"]
    assert run.forbidden_modules({"jaxtyping", "flaxen", "vggt_qwen3_tpu_extra"}) == []
