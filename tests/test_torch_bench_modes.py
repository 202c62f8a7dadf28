"""The port's bench modes e2e, qa, spec, serve, serve_sla and ring
(``python -m vggt_qwen3_tpu_torch.bench --mode M``) on the CPU, held to the
JAX functions the root ``bench.py``'s modes call.

- Every mode (the six new ones) runs at ``--tiny --device cpu`` from its
  argument parser in this process and ends in one JSON line holding the root
  bench's metric name; one mode also runs as ``python -m``. Without a card
  and without ``--device cpu`` each raises.
- The workload builders equal the root bench's numpy draws element for
  element (the root's code copied here): the e2e/qa views and ids, the spec
  prompts and FSM table, the serve prompts and budgets, the ring inputs.
- e2e and qa: the tokens of the whole query, its first token and the
  early-exit curve's tokens and steps (= the budget) equal JAX's
  ``_vision_splice_generate`` / ``_vision_splice_early_exit`` on the same
  weights (qa with the int8 cache); exact.
- spec: ``generate`` and ``generate_speculative`` (constrained and free) and
  the action query (``_vision_splice_generate`` /
  ``_vision_splice_speculative``): the same tokens and iteration counts;
  exact.
- serve and serve_sla: JAX's ``SlotEngine`` on the same prompts, budgets
  and FSM table with a float32 cache, driven as the root modes drive it:
  the same tokens per request (serve: also the scheduler's counts); exact.
- ring: the mode's two-chunk merge and one-rank ring equal the direct forward
  within its own limit (0.05 × the output scale), and its merge equals the
  plain version's merge of JAX's shape, within 1e-6 in float32.

The tiny modes run float32 weights (JAX's init, matrices ×4 so attention
moves the tokens, through ``utils.from_jax``) and, but in qa, the model-dtype
cache; JAX's Qwen3 prefill runs through its flash kernel in interpret mode,
the TPU's path.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.inference import batching as jbatching
from vggt_qwen3_tpu.inference import engine as jengine
from vggt_qwen3_tpu.inference import speculative as jspec
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.models import vlm as jvlm
from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu_torch import bench
from vggt_qwen3_tpu_torch.ops import flash_attention as pflash
from vggt_qwen3_tpu_torch.ops import ring_attention as pring
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

REPO = Path(__file__).resolve().parents[1]
METRICS = dict(e2e="e2e_single_view_query_ms", qa="qa_samples_per_sec_chip", spec="spec_decode_json_speedup",
               serve="served_requests_per_sec", serve_sla="serve_sla_p99_ttft_ms", ring="ring_32view_flash_ms")


def tiny_args(mode, *extra):
    return bench.parse_args(["--mode", mode, "--tiny", "--device", "cpu", *extra])


def jax_vlm_config():
    """JAX's counterpart of ``bench.vlm_config`` at ``--tiny``."""
    return jconfig.VLMConfig(
        text=dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32"),
        vision=dataclasses.replace(jconfig.VGGT_TINY, dtype="float32"),
        projector=jconfig.PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128),
        num_vis_tokens=16, geom_tokens=0, dtype="float32")


@pytest.fixture(scope="module")
def trees():
    """(JAX's tiny VLM weights, the port's copy): float32, matrices ×4."""
    jp = jvlm.init_params(jax.random.PRNGKey(0), jax_vlm_config(), dtype="float32")
    jp = jax.tree.map(lambda a: a * 4.0 if a.ndim >= 2 else a, jp)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture
def jax_prefill_flash(monkeypatch):
    """JAX's Qwen3 prefill through its flash kernel in interpret mode."""
    def attend(q, k, v, *, causal=False, kv_start=None, kv_end=None):
        return jax_flash(q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, interpret=True)

    jax.clear_caches()
    monkeypatch.setattr(jqwen3, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jqwen3, "attend", attend)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("mode", ["e2e", "qa", "spec", "serve", "serve_sla", "ring"])
def test_mode_runs_tiny_from_its_parser_and_ends_in_its_metric_line(mode, capsys):
    res = bench.main(["--mode", mode, "--tiny", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["metric"] == METRICS[mode] == res["metric"] and last["mode"] == mode
    assert np.isfinite(last["value"]) and last["value"] > 0 and last["device"] == "cpu" and last["card"] is None
    assert "tokens" not in last and len(lines) == 2  # the figures' line, then the JSON line


def test_a_mode_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "vggt_qwen3_tpu_torch.bench", "--mode", "e2e", "--tiny", "--device",
                           "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["metric"] == "e2e_single_view_query_ms" and sorted(map(int, last["early_exit"])) == [2, 4, 8, 16, 32]


@pytest.mark.parametrize("mode", ["e2e", "qa", "spec", "serve", "serve_sla", "ring"])
def test_mode_raises_without_a_card_unless_asked_for_the_cpu(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.MODE_FNS[mode](bench.parse_args(["--mode", mode, "--tiny"]))


@pytest.mark.parametrize("mode", ["e2e", "qa", "spec", "serve", "serve_sla", "ring"])
def test_tiny_mode_takes_dense_text_and_refuses_another_quant(mode):
    assert bench.parse_args(["--mode", mode, "--tiny"]).quant == "none"
    assert bench.parse_args(["--mode", mode, "--tiny", "--quant", "none"]).quant == "none"
    assert bench.parse_args(["--mode", mode]).quant == "w8"
    with pytest.raises(SystemExit):
        bench.parse_args(["--mode", mode, "--tiny", "--quant", "w8"])
    # the decode mode takes --quant at --tiny too
    assert bench.parse_args(["--tiny", "--quant", "w8a8"]).quant == "w8a8"
    assert bench.parse_args(["--tiny"]).quant == "w8"


def test_workload_builders_equal_the_root_bench_draws():
    full = bench.parse_args(["--mode", "qa"])
    cfg = bench.vlm_config(full)
    V = cfg.text.vocab_size
    img_id = V - 1
    for B in (1, 32):  # e2e, qa (root bench.py:230-231, :359-360)
        images, ids, mask, got_img = bench.query_inputs(cfg, B, 448, "cpu")
        root_images = np.random.default_rng(0).uniform(0, 1, (B, 1, 3, 448, 448))
        root_ids = np.random.default_rng(1).integers(1, 150_000, (B, 30))
        assert got_img == img_id and images.dtype == torch.bfloat16
        assert torch.equal(images, torch.from_numpy(root_images).to(torch.bfloat16))
        assert np.array_equal(ids.numpy()[:, np.arange(30) != 10], root_ids[:, np.arange(30) != 10])
        assert (ids[:, 10] == img_id).all() and mask.all()
    # spec (root bench.py:1263-1274, :1363-1365)
    cycle = [t % (V - 2) + 1 for t in [101, 5, 72, 880, 14, 3301, 9, 42, 7, 615, 23, 11]]
    table = np.full((len(cycle), V), -1, np.int32)
    for s, t in enumerate(cycle):
        table[s, t] = (s + 1) % len(cycle)
    assert np.array_equal(bench.cycle_table(bench.fsm_cycle(bench.SPEC_CYCLE, V), V, "cpu").numpy(), table)
    idsnp = np.random.default_rng(0).integers(1, V, (3, 32))
    idsnp[:, -len(cycle):] = cycle
    assert np.array_equal(bench.spec_prompt(V, 3), idsnp)
    aidsnp = np.random.default_rng(2).integers(1, V, (1, 32))
    aidsnp[:, -len(cycle):] = cycle
    assert np.array_equal(bench.spec_prompt(V, 1, seed=2), aidsnp)
    # serve / serve_sla (root bench.py:887, :919-933)
    for struct in (False, True):
        cyc = [t % (V - 2) + 1 for t in [7, 23, 5, 41, 9, 42, 11, 3301]]
        rng = np.random.default_rng(0)
        root_ids, root_budgets = [], []
        for i in range(64):
            row = rng.integers(1, V, (1, 32))
            if struct:
                row[0, -len(cyc):] = cyc
            root_ids.append(row[0])
            lo = max(1, 32 // 4)
            root_budgets.append(lo + i % (32 - lo + 1))
        ids, budgets = bench.serve_workload(V, 64, 32, 32, struct)
        assert np.array_equal(ids, np.stack(root_ids)) and budgets == root_budgets
    # ring at --tiny (root bench.py:1157-1164): the full shape holds 800 MB of float64 draws
    q, k, v = bench.ring_inputs(tiny_args("ring"), "cpu")
    rng = np.random.default_rng(0)
    for got in (q, k, v):
        assert torch.equal(got, torch.from_numpy(rng.normal(size=(1, 72, 4, 16))).to(torch.bfloat16))


def _jax_query(jp, cfg, B, image_size, seed_ids=1):
    images = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (B, 1, 3, image_size, image_size)), jnp.float32)
    ids = np.random.default_rng(seed_ids).integers(1, cfg.text.vocab_size - 1, (B, 30))
    ids[:, 10] = cfg.text.vocab_size - 1
    return images, jnp.asarray(ids), jnp.ones((B, 30), jnp.int32)


def test_e2e_tokens_ttft_and_early_exit_match_jax(trees, jax_prefill_flash):
    jp, pp = trees
    res = bench.e2e_mode(tiny_args("e2e"), params=pp, reps=1)
    cfg = jax_vlm_config()
    img_id = cfg.text.vocab_size - 1
    images, ids, mask = _jax_query(jp, cfg, 1, 56)
    gen = jengine.GenerationConfig(max_new_tokens=32, pad_token_id=0, repetition_penalty=1.1)
    toks, _ = jbatching._vision_splice_generate(jp, cfg, gen, img_id, images, ids, mask)
    assert res["tokens"] == np.asarray(toks)[0].tolist()
    first, _ = jbatching._vision_splice_generate(jp, cfg, dataclasses.replace(gen, max_new_tokens=1), img_id, images,
                                                 ids, mask)
    assert res["first_token"] == int(np.asarray(first)[0, 0])
    assert len(set(res["tokens"])) > 3  # the weights move the tokens
    for k in bench.EARLY_EXIT_BUDGETS:
        packed, steps = jbatching._vision_splice_early_exit(jp, cfg, gen, img_id, images, ids, mask,
                                                            budget=jnp.full((1,), k, jnp.int32))
        assert res["early_exit"][k]["steps"] == int(steps) == k
        assert res["early_exit_tokens"][k] == np.asarray(packed)[0, :32].tolist()
        assert res["early_exit_tokens"][k][:k] == res["tokens"][:k]


def test_qa_tokens_match_jax_with_the_int8_cache(trees, jax_prefill_flash):
    jp, pp = trees
    res = bench.qa_mode(tiny_args("qa"), params=pp, reps=1)
    cfg = jax_vlm_config()
    images, ids, mask = _jax_query(jp, cfg, 2, 56)
    gen = jengine.GenerationConfig(max_new_tokens=32, pad_token_id=0, repetition_penalty=1.1, kv_dtype="int8")
    toks, _ = jbatching._vision_splice_generate(jp, cfg, gen, cfg.text.vocab_size - 1, images, ids, mask)
    assert res["batch"] == 2 and res["tokens"] == np.asarray(toks).tolist()


def test_spec_tokens_and_iterations_match_jax(trees, jax_prefill_flash):
    jp, pp = trees
    res = bench.spec_mode(tiny_args("spec"), params=pp, reps=1)
    cfg = jax_vlm_config()
    tcfg = cfg.text
    V, N, k = tcfg.vocab_size, 16, 4
    cycle = [t % (V - 2) + 1 for t in [101, 5, 72, 880, 14, 3301, 9, 42, 7, 615, 23, 11]]
    table = np.full((len(cycle), V), -1, np.int32)
    for s, t in enumerate(cycle):
        table[s, t] = (s + 1) % len(cycle)
    constraint = jnp.asarray(table)
    ids = jnp.asarray(bench.spec_prompt(V, 1))
    kw = dict(inputs_embeds=jqwen3.embed_tokens(jp["text"], ids), attention_mask=jnp.ones((1, 32), jnp.int32))
    gen = jengine.GenerationConfig(max_new_tokens=N, pad_token_id=0)
    runs = res["runs"]
    for label, c in (("constrained", constraint), ("free", None)):
        toks, _ = jengine.generate(jp["text"], tcfg, gen, constraint=c, **kw)
        stoks, _, iters = jspec.generate_speculative(jp["text"], tcfg, gen, prompt_ids=ids, constraint=c, draft_k=k,
                                                     ngram=3, **kw)
        assert runs[f"generate_{label}"]["tokens"] == np.asarray(toks).tolist()
        assert runs[f"speculative_{label}"]["tokens"] == np.asarray(stoks).tolist() == np.asarray(toks).tolist()
        assert runs[f"speculative_{label}"]["iterations"] == int(iters)
    assert runs["speculative_constrained"]["iterations"] < N  # the skeleton is drafted
    img_id = V - 1
    images = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (1, 1, 3, 56, 56)), jnp.float32)
    aids = bench.spec_prompt(V, 1, seed=2)
    aids[:, 4] = img_id
    aids, amask = jnp.asarray(aids), jnp.ones((1, 32), jnp.int32)
    agen = jengine.GenerationConfig(max_new_tokens=16, pad_token_id=0)
    toks, _ = jbatching._vision_splice_generate(jp, cfg, agen, img_id, images, aids, amask, constraint)
    packed, iters = jbatching._vision_splice_speculative(jp, cfg, agen, img_id, k, 3, images, aids, amask,
                                                         constraint=constraint)
    assert runs["action_plain"]["tokens"] == np.asarray(toks).tolist() == np.asarray(packed)[:, :16].tolist()
    assert runs["action_speculative"]["tokens"] == runs["action_plain"]["tokens"]
    assert runs["action_speculative"]["iterations"] == int(iters)


def test_ring_mode_holds_its_merge_and_ring_to_the_direct_forward():
    args = tiny_args("ring")
    res = bench.ring_mode(args, reps=1)
    assert res["ok"] and res["ring_max_abs_diff"] == 0.0  # one rank: the direct forward bit for bit
    assert res["merge_max_abs_diff"] < 0.05 * res["output_scale"] and res["shape"] == [1, 72, 4, 16]
    assert not torch.distributed.is_initialized()
    # the merge is the JAX ring's combine: in float32 it equals the whole softmax
    q, k, v = (t.float() for t in bench.ring_inputs(args, "cpu"))
    halves = [pflash.flash_attention_with_lse(q, k[:, a:b], v[:, a:b]) for a, b in ((0, 36), (36, 72))]
    merged = pring.merge_chunks([o for o, _ in halves], [l for _, l in halves], q.dtype)
    np.testing.assert_allclose(merged.numpy(), pflash.flash_attention(q, k, v).numpy(), atol=1e-6, rtol=1e-6)


def _jax_serve(jtext, n_req, slots, P, N, *, struct, spec, guard, warm):
    """The root ``serve_mode``'s engine and schedule on JAX's ``SlotEngine``
    (float32 cache): ``warm`` requests first, then every count reset and the
    speculative chunks restored with an empty guard window, as the port's
    mode resets its engine, then all ``n_req`` → (tokens a request, stats)."""
    from vggt_qwen3_tpu.inference import slots as jslots

    cfg = dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32")
    V = cfg.vocab_size
    cyc = [t % (V - 2) + 1 for t in [7, 23, 5, 41, 9, 42, 11, 3301]]
    constraint = None
    if struct:
        table = np.full((len(cyc), V), -1, np.int32)
        for s, t in enumerate(cyc):
            table[s, t] = (s + 1) % len(cyc)
        constraint = jnp.asarray(table)
    gen = jengine.GenerationConfig(max_new_tokens=N, eos_token_id=None, pad_token_id=0)
    eng = jslots.SlotEngine(jtext, cfg, gen, num_slots=slots, max_len=P + N, decode_chunk=4, speculative=spec,
                            constraint=constraint, spec_min_gain=guard)
    ids, budgets = bench.serve_workload(V, n_req, P, N, struct)
    prompts = [(np.asarray(jqwen3.embed_tokens(jtext, jnp.asarray(ids[i:i + 1]))), np.ones((1, P), np.int32),
                ids[i:i + 1].astype(np.int32)) for i in range(n_req)]

    def run(n):
        futs = [eng.submit_embeds(e, m, max_new_tokens=b, lookup_ids=lid if spec else None)
                for (e, m, lid), b in zip(prompts[:n], budgets[:n])]
        eng.run_until_idle()
        return [np.asarray(f.result(timeout=0)[0]).tolist() for f in futs]

    if warm:
        run(warm)
        eng.stats = jslots.SlotStats()
        eng.speculative = spec
        eng._spec_gain_window.clear()
    return run(n_req), eng.stats


@pytest.mark.parametrize("flags", [(), ("--serve_spec",)], ids=["free", "structured+spec"])
def test_serve_tokens_and_schedule_match_jax_slot_engine(trees, jax_prefill_flash, flags):
    """serve at ``--tiny``: 8 requests of prompt 8 and budgets cycled over
    [2, 8] on 4 slots after a warm-up pass: every request's tokens and the
    scheduler's counts equal JAX's ``SlotEngine`` run the same way."""
    jp, pp = trees
    res = bench.serve_mode(tiny_args("serve", *flags), params=pp)
    spec = bool(flags)
    tokens, stats = _jax_serve(jp["text"], 8, 4, 8, 8, struct=spec, spec=spec, guard=1.35, warm=16)
    assert res["tokens"] == tokens
    assert [len(t) for t in tokens] == bench.serve_workload(512, 8, 8, 8, spec)[1]
    for name in ("chunks", "admitted_mid_decode", "admit_dispatches", "spec_blocks", "spec_accepted",
                 "spec_disabled_at"):
        assert res[name] == getattr(stats, name), name
    assert res["served_tok_s"] * res["wall_s"] == pytest.approx(stats.tokens)


def test_serve_sla_tokens_match_jax_slot_engine_in_every_phase(trees, jax_prefill_flash):
    """serve_sla at ``--tiny``: the closed passes and each open-loop load
    (Poisson arrivals on the engine's thread, so the schedule varies) give
    every request the tokens JAX's ``SlotEngine`` gives it (a float32 cache:
    a request's tokens do not depend on the schedule)."""
    jp, pp = trees
    res = bench.serve_sla_mode(tiny_args("serve_sla"), params=pp)
    tokens, _ = _jax_serve(jp["text"], 8, 4, 8, 8, struct=False, spec=False, guard=1.35, warm=0)
    assert res["closed_tokens"] == tokens
    assert [r["load"] for r in res["loads"]] == [0.5, 1.0, 1.5] and res["value"] == res["loads"][1]["ttft_p99_ms"]
    for r in res["loads"]:
        assert r["tokens"] == tokens and r["ttft_p99_ms"] >= r["ttft_p50_ms"] > 0
