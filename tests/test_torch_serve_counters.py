"""The serve modes' reported counters cover their timed pass alone
(``bench.serve_mode``, ``bench.serve_sla_mode``), at ``--tiny`` on the CPU.

- serve, free and ``--serve_spec``: after a warm-up pass of 8 requests (2
  slots), the timed pass of 12 reports the tokens, chunks, admissions, KV
  occupancy and speculative blocks of a fresh engine that runs those 12
  requests alone; exact (the same integers).
- serve ``--serve_spec`` with a guard that trips at the first verify block
  it sees: the warm-up trips it, and the timed pass still submits every
  request to a speculative engine and counts what a fresh engine counts
  (which trips it again, within the pass).
- serve_sla: the engine's counts after the loads are the loads' alone (the
  closed passes' admissions reported apart).

The weights are the modes' own seeded random ones (``bench.text_params``,
float32, a float32 cache: a request's tokens do not depend on the
schedule). No JAX.
"""

import numpy as np
import pytest

from vggt_qwen3_tpu_torch import bench

FLAGS = ("--serve_reqs", "12", "--slots", "2")  # a warm-up pass of min(12, 4·2) = 8 requests, then 12
WARM, TIMED = 8, 12


def mode_args(mode, *extra):
    return bench.parse_args(["--mode", mode, "--tiny", "--device", "cpu", *FLAGS, *extra])


@pytest.fixture(scope="module")
def params():
    return bench.text_params(mode_args("serve"))


def tripping_guard(monkeypatch):
    """Every engine the modes build turns speculation off at the first
    verify block whose acceptance it reads."""
    make = bench._slot_engine

    def build(*a, **k):
        out = make(*a, **k)
        out[0].spec_min_gain, out[0].spec_guard_window = 1e9, 1
        return out

    monkeypatch.setattr(bench, "_slot_engine", build)


def alone(args, params):
    """The timed pass's requests on a fresh engine → (tokens, its stats)."""
    eng, prompts, budgets, _ = bench._slot_engine(args, params, TIMED, track_metrics=False, guard=1.35)
    futs = [bench._submit(eng, prompts, budgets, i) for i in range(TIMED)]
    eng.run_until_idle()
    return [np.asarray(f.result(timeout=0)[0]).tolist() for f in futs], eng.stats


def assert_counts_of(res, tokens, st):
    assert res["tokens"] == tokens
    for name in ("chunks", "admitted_mid_decode", "admit_dispatches", "spec_blocks", "spec_accepted"):
        assert res[name] == getattr(st, name), name
    assert res["kv_occupancy"] == st.kv_utilization
    assert res["served_tok_s"] * res["wall_s"] == pytest.approx(st.tokens)


@pytest.mark.parametrize("flags", [(), ("--serve_spec",)], ids=["free", "structured+spec"])
def test_serve_counts_its_timed_pass_alone(params, flags):
    args = mode_args("serve", *flags)
    res = bench.serve_mode(args, params=params)
    tokens, st = alone(args, params)
    assert res["warmup_admit_dispatches"] > 0 and res["requests"] == TIMED
    assert_counts_of(res, tokens, st)
    assert (st.spec_blocks > 0) == bool(flags) and res["spec_disabled_at"] is None


def test_serve_spec_starts_its_timed_pass_speculative_after_the_guard_tripped(params, monkeypatch):
    tripping_guard(monkeypatch)
    speculative_at_submit = []
    submit = bench._submit
    monkeypatch.setattr(bench, "_submit",
                        lambda eng, *a: speculative_at_submit.append(eng.speculative) or submit(eng, *a))
    args = mode_args("serve", "--serve_spec")
    res = bench.serve_mode(args, params=params)
    assert len(speculative_at_submit) == WARM + TIMED and all(speculative_at_submit)
    tokens, st = alone(args, params)
    assert st.spec_disabled_at is not None and st.spec_blocks > 0  # the guard trips within the pass alone too
    assert_counts_of(res, tokens, st)
    assert res["spec_disabled_at"] is not None


def test_serve_sla_counts_its_loads_alone(params, monkeypatch):
    engines = []
    make = bench._slot_engine
    monkeypatch.setattr(bench, "_slot_engine", lambda *a, **k: engines.append(make(*a, **k)) or engines[-1])
    res = bench.serve_sla_mode(mode_args("serve_sla"), params=params)
    n_req, st = len(res["closed_tokens"]), engines[0][0].stats
    assert res["closed_admit_dispatches"] > 0 and res["admit_dispatches"] == st.admit_dispatches > 0
    assert res["requests_served"] == st.requests == n_req * len(res["loads"])
    assert st.tokens == sum(len(t) for load in res["loads"] for t in load["tokens"])
