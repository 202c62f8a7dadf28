"""Whole runs of each cell at the tiny sizes on the CPU (``tiny.shrink``):
each driver agrees with ``benchmark/reference`` under the cell's limits;
the window's rate falls when a stall is put into it; and with the timed path
broken underneath — a step that leaves the state unchanged, half of the
batch left out, a served token altered — ``correct`` comes out false, as it
does for the control in the program's place. The last test runs the control
at the cell's own size and needs the card (``pytest -m gpu benchmark/tests``
there); it alone holds the QA cell's control, which the tiny sizes cannot part
from the program."""

import time

import pytest
import torch

from benchmark import control, manifest, run
from benchmark.tests import tiny

TRAIN = ["stage1-train-qlora", "stage2-train-qlora"]


def tiny_run(cell, seconds=0.2, seed=5):
    return run.run_cell(cell, seed, seconds, False, device="cpu", adjust=tiny.shrink)


@pytest.mark.parametrize("cell", TRAIN + ["stage1-qa-b32"])
def test_each_cell_agrees_with_the_reference(cell):
    res = tiny_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(res)[list(res).index("checks")] == "checks"


def test_a_stall_in_the_window_lowers_the_rate(monkeypatch):
    drv = manifest.driver("train")
    quick = tiny_run("stage1-train-qlora", seconds=0.5)["metrics"]["train_tokens_per_s"]["value"]
    step = drv.Session.step

    def stalled(self, i, rec):
        time.sleep(0.5)
        return step(self, i, rec)

    monkeypatch.setattr(drv.Session, "step", stalled)
    slow = tiny_run("stage1-train-qlora", seconds=0.5)["metrics"]["train_tokens_per_s"]["value"]
    assert slow < 0.7 * quick


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from vggt_qwen3_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Optimizer, "_apply", lambda self, grads, state, params: None)
    res = tiny_run("stage1-train-qlora")
    assert not res["correct"] and res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from vggt_qwen3_tpu_torch.models import vlm

    forward = vlm.train_forward

    def half(params, cfg, *, images, geom_token, input_ids, attention_mask, labels, **kw):
        n = images.shape[0] // 2
        return forward(params, cfg, images=images[:n], geom_token={k: v[:n] for k, v in geom_token.items()},
                       input_ids=input_ids[:n], attention_mask=attention_mask[:n], labels=labels[:n], **kw)

    monkeypatch.setattr(vlm, "train_forward", half)
    res = tiny_run("stage2-train-qlora")
    assert not res["correct"], res["checks"]


def test_an_altered_token_is_not_correct(monkeypatch):
    from vggt_qwen3_tpu_torch.inference import engine

    decode = engine._decode

    def altered(*args, **kw):
        packed, steps = decode(*args, **kw)
        packed[:, 1] = (packed[:, 1] + 1) % 200
        return packed, steps

    monkeypatch.setattr(engine, "_decode", altered)
    res = tiny_run("stage1-qa-b32")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_the_control_in_the_programs_place_is_not_correct(cell):
    c = manifest.cell(cell)
    tiny.shrink(c)
    for seed in (1, 2, 3):
        got = control.readings(c, seed, torch.device("cpu"))
        limits = c["spec"]["limits"]
        assert any(got["control"][n] > lim for n, lim in limits.items()), got["control"]
        assert any(got["half_batch"][n] > lim for n, lim in limits.items()), got["half_batch"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN + ["stage1-qa-b32"])
def test_the_control_at_the_cells_size_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size (pytest -m gpu benchmark/tests)")
    c = manifest.cell(cell)
    limits = c["spec"]["limits"]
    for seed in (11, 12, 13):
        if c["spec"]["driver"] == "qa":
            # at the tiny sizes the float8 reference puts the served token first everywhere: only here it parts
            got = control.qa_readings(c, seed, torch.device("cuda"))
            assert got["program"] <= limits["logit_gap"] < got["control"], got
            continue
        got = control.readings(c, seed, torch.device("cuda"))
        assert any(got["control"][n] > lim for n, lim in limits.items()), got["control"]
