"""The port's slot engine (``inference/slots.py``) and the pieces of the
serving path it brings, against the JAX package.

- ``SlotEngine``: the same schedule (``submit_embeds`` / ``step_once`` /
  ``run_until_idle``) run inline through the port's engine and JAX's gives
  the same tokens, lengths and scheduler statistics (chunks, mid-decode
  admissions, admission dispatches and log, delivered tokens, KV occupancy,
  verify blocks, accepted tokens, where the guard tripped), and every
  request's tokens equal JAX's ``engine.generate`` of its whole prompt
  (prefix + suffix), cut at its length. The schedules cover batched
  admission (A = 4, 2, 1), mid-decode admission, EOS freeing a slot and its
  reuse, per-request budgets (one shorter than a chunk: the lagged snapshot
  must not deliver a reused slot), prefixed admission (the chunked prefill,
  then decode over holed rows) and a rejected oversized prompt, with a
  float32, a bf16 and an int8 cache; the speculative schedules are in
  ``tests/test_torch_slots_speculative.py``, which uses the helpers here.
- The chunked-prefill route of ``qwen3.forward_hidden`` (S > 1 at
  ``cache_offset = P``): logits and written cache slots against JAX's
  ``qwen3.forward`` (1e-4 absolute, float32).
- ``ops.attention.mha_quantized_kv`` against JAX's (1e-5 absolute).
- ``vlm.quantize_vision("w8")``: the quantized leaves equal JAX's bit for
  bit, and the tiny VGGT aggregator's output with them agrees with JAX's
  (1e-4 absolute).

Weights are JAX's (float32, matrices scaled ×4 so attention moves the
logits), prompts numpy-seeded, both sides fed the same embeddings. JAX's
prefills run through its flash kernel in interpret mode (the TPU's path);
with a bf16 cache its decode steps and verify blocks run through its
decode-attention kernel in interpret mode too (XLA attention over a bf16
cache under f32 weights rounds P to bf16; the kernels do not), as
``tests/test_torch_arkit_slice.py`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.inference import engine as jengine
from vggt_qwen3_tpu.inference import slots as jslots
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.models import vggt as jvggt
from vggt_qwen3_tpu.models import vlm as jvlm
from vggt_qwen3_tpu.ops import attention as jattention
from vggt_qwen3_tpu.ops import decode_attention as jdecode
from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.inference import engine as pengine
from vggt_qwen3_tpu_torch.inference import slots as pslots
from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3
from vggt_qwen3_tpu_torch.models import vggt as pvggt
from vggt_qwen3_tpu_torch.models import vlm as pvlm
from vggt_qwen3_tpu_torch.ops import attention as pattention
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

TOL = 1e-4
N = 10          # the engines' max_new_tokens
SLOTS = 4
MAX_LEN = 48    # row length 64 with or without a verify block's scratch
BUCKET = 16


@pytest.fixture(scope="module")
def model():
    jcfg = jconfig.QWEN3_TINY
    jp = jqwen3.init_params(jax.random.PRNGKey(0), jcfg, dtype="float32")
    jp = jax.tree.map(lambda a: a * 4.0 if a.ndim >= 2 else a, jp)
    return jcfg, pconfig.QWEN3_TINY, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture
def jax_kernels(monkeypatch):
    """JAX's prefills through its flash kernel; ``bf16()`` sends its decode
    steps and verify blocks through the decode-attention kernel as well
    (interpret mode both)."""
    def attend(q, k, v, *, causal=False, kv_start=None, kv_end=None):
        return jax_flash(q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, interpret=True)

    def bf16():
        monkeypatch.setenv("VGGT_DECODE_KERNEL", "force")
        monkeypatch.setattr(jdecode, "decode_attention_eligible", lambda *a: True)

    jax.clear_caches()
    monkeypatch.setattr(jqwen3, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jqwen3, "attend", attend)
    yield bf16
    jax.clear_caches()


def _request(jp, seed, S, bucket=BUCKET, **kw):
    """A left-padded prompt: ids [1, bucket], mask, embeds (JAX's embedding)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, bucket - S:] = rng.integers(1, 512, S)
    mask = (ids != 0).astype(np.int32)
    emb = np.asarray(jqwen3.embed_tokens(jp, jnp.asarray(ids)))
    return dict(ids=ids, mask=mask, emb=emb, **kw)


def _drive(engine_cls, params, cfg, gen_cfg, schedule, **kw):
    """Run ``schedule`` inline: ("prefix", ids, emb) registers a prefix;
    ("submit", request) enqueues (on the last prefix if the request has
    ``prefix``); ("step", n) runs n scheduler iterations. Then run until
    idle → ([(tokens, n) or "rejected"], stats without wall times)."""
    eng = engine_cls(params, cfg, gen_cfg, num_slots=SLOTS, max_len=MAX_LEN, **kw)
    futs, pid = [], None
    for op in schedule:
        if op[0] == "prefix":
            pid = eng.register_prefix(op[2])
        elif op[0] == "submit":
            r = op[1]
            futs.append(eng.submit_embeds(r["emb"], r["mask"], max_new_tokens=r.get("budget"),
                                          prefix_id=pid if r.get("prefix") else None,
                                          lookup_ids=r.get("lookup")))
        else:
            for _ in range(op[1]):
                eng.step_once()
    eng.run_until_idle()
    out = []
    for f in futs:
        try:
            toks, n = f.result(timeout=0)
            out.append((np.asarray(toks).tolist(), int(n)))
        except ValueError:
            out.append("rejected")
    stats = dataclasses.asdict(eng.stats)
    stats.pop("admission_wait_s")
    return out, stats


def _reference(jp, jcfg, gen_kw, schedule, constraint=None):
    """JAX's engine.generate of each submitted request's whole prompt."""
    prefix = None
    refs = []
    for op in schedule:
        if op[0] == "prefix":
            prefix = op[1]
        elif op[0] == "submit":
            r = op[1]
            ids, mask = r["ids"], r["mask"]
            if r.get("prefix"):  # the suffix's pads go first: the same positions and keys, one run
                pad = int((mask == 0).sum())
                ids = np.concatenate([ids[:, :pad], prefix, ids[:, pad:]], axis=1)
                mask = (ids != 0).astype(np.int32)
            toks, lengths = jengine.generate(
                jp, jcfg, jengine.GenerationConfig(**gen_kw),
                inputs_embeds=jqwen3.embed_tokens(jp, jnp.asarray(ids)), attention_mask=jnp.asarray(mask),
                constraint=constraint)
            refs.append((np.asarray(toks)[0], int(np.asarray(lengths)[0])))
    return refs


def _held(model, jax_kernels, kv, gen_kw, schedule, jconstraint=None, pconstraint=None, exact=None, **kw):
    """The schedule through both engines and the JAX reference; returns the
    port's results and stats after holding them to JAX's. Every request is
    held to JAX's SlotEngine; those in ``exact`` (default all) to JAX's
    engine.generate of their whole prompt too.

    Two things leave a quantized cache's tokens off engine.generate's, in
    JAX and in the port alike: a prefixed request's suffix attends to the
    prefix's K/V as stored (bf16 or int8) where a whole-prompt prefill uses
    them unrounded; and with a bf16 cache a step over holed rows (after a
    prefixed admission) takes plain attention, which rounds P to bf16, where
    engine.generate's frontier kernels do not."""
    jcfg, pcfg, jp, pp = model
    gen_kw = dict(gen_kw, kv_dtype=kv)
    if kv == "bfloat16":
        jax_kernels()
    p_out, p_stats = _drive(pslots.SlotEngine, pp, pcfg, pengine.GenerationConfig(**gen_kw), schedule,
                            constraint=pconstraint, **kw)
    j_out, j_stats = _drive(jslots.SlotEngine, jp, jcfg, jengine.GenerationConfig(**gen_kw), schedule,
                            constraint=jconstraint, **kw)
    assert p_out == j_out
    assert p_stats == j_stats
    refs = _reference(jp, jcfg, gen_kw, schedule, jconstraint)
    for i, (got, (ref, length)) in enumerate(zip(p_out, refs)):
        if got == "rejected" or (exact is not None and i not in exact):
            continue
        toks, n = got
        assert n <= length and toks == ref[:n].tolist()
    return p_out, p_stats


def _eos(model, req):
    """A token the request's greedy generation emits at step 3."""
    jcfg, _, jp, _ = model
    probe = _reference(jp, jcfg, dict(max_new_tokens=N, pad_token_id=0, repetition_penalty=1.1),
                       [("submit", req)])
    return int(probe[0][0][3])


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_slot_engine_serving_schedule_matches_jax(model, jax_kernels, kv):
    """Four requests admitted at once (A = 4), one with a budget of 2 (under
    a chunk: it finishes and its slot is reused while its lagged snapshot is
    read), an EOS that frees a slot early; after two chunks, two prefixed
    requests (dense and left-padded suffixes: the chunked prefill, then
    every step over holed rows), two plain ones and an oversized prompt
    (rejected, no slot taken). With the float32 cache every request equals
    engine.generate; with int8 all but the prefixed two; with bf16 the two
    that finish before the first prefixed admission."""
    jp = model[2]
    reqs = [_request(jp, 10 + i, S=7 + i) for i in range(4)]
    reqs[1]["budget"] = 2
    reqs[3]["budget"] = 6
    eos = _eos(model, reqs[0])
    prefix = np.random.default_rng(5).integers(1, 512, (1, 6)).astype(np.int32)
    later = [_request(jp, 20, S=8, bucket=8, prefix=True), _request(jp, 21, S=5, bucket=8, prefix=True),
             _request(jp, 22, S=9), _request(jp, 23, S=12, budget=3),
             _request(jp, 24, S=MAX_LEN - N + 1, bucket=MAX_LEN - N + 1)]
    schedule = ([("submit", r) for r in reqs] + [("step", 2)]
                + [("prefix", prefix, np.asarray(jqwen3.embed_tokens(jp, jnp.asarray(prefix))))]
                + [("submit", r) for r in later])
    out, stats = _held(model, jax_kernels, kv, dict(max_new_tokens=N, eos_token_id=eos, pad_token_id=0,
                                                    repetition_penalty=1.1), schedule, decode_chunk=2,
                       exact={"float32": None, "int8": (0, 1, 2, 3, 6, 7), "bfloat16": (0, 1)}[kv])
    assert out[-1] == "rejected" and stats["requests"] == 8
    assert out[0][1] == 4 and out[0][0][-1] == eos  # EOS at step 3, counted
    assert [n for _, n in out[1:4]] == [2, N, 6] and stats["admitted_mid_decode"] >= 4
    assert stats["admit_dispatches"] < stats["requests"] and 0 < stats["kv_used_token_chunks"]


def test_batched_admission_matches_jax_and_one_by_one(model, jax_kernels):
    """Seven same-bucket requests on eight slots admit as 4 + 2 + 1 (three
    dispatches) and give the tokens of admitting them one by one."""
    jp = model[2]
    reqs = [_request(jp, 100 + i, S=7 + i % 4, budget=5 + i % 3) for i in range(7)]
    schedule = [("submit", r) for r in reqs]
    gen_kw = dict(max_new_tokens=N, pad_token_id=0, repetition_penalty=1.1)
    global SLOTS
    slots, SLOTS = SLOTS, 8
    try:
        out, stats = _held(model, jax_kernels, "int8", gen_kw, schedule, decode_chunk=2, admit_batch_max=4)
        one, one_stats = _drive(pslots.SlotEngine, model[3], model[1],
                                pengine.GenerationConfig(**gen_kw, kv_dtype="int8"), schedule, decode_chunk=2,
                                admit_batch_max=1)
    finally:
        SLOTS = slots
    assert stats["admit_dispatches"] == 3 and one_stats["admit_dispatches"] == 7
    assert out == one


def test_chunked_prefill_matches_jax_forward(model):
    """A left-padded suffix prefilled at cache_offset = P over a prefix
    already in the cache (no prefill_padding: plain attention over the
    cache, causal at the offset) gives JAX's logits and writes JAX's cache
    slots, float32 and int8 caches."""
    jcfg, pcfg, jp, pp = model
    P, S, T = 6, 8, 24
    rng = np.random.default_rng(60)
    for kv in ("float32", "int8"):
        pre = rng.integers(1, 512, (2, P)).astype(np.int32)
        suf = rng.integers(1, 512, (2, S)).astype(np.int32)
        am = np.zeros((2, T), np.int32)
        am[:, :P] = 1
        am[0, P:P + S] = 1
        am[1, P + 3:P + S] = 1  # row 1's suffix is left-padded by 3
        pos = P + np.maximum(np.cumsum(am[:, P:P + S], -1) - 1, 0)
        pre_mask = np.zeros((2, T), np.int32)
        pre_mask[:, :P] = 1
        jc = jqwen3.init_cache(jcfg, 2, T, dtype=kv)
        _, jc = jqwen3.forward(jp, jcfg, input_ids=jnp.asarray(pre), attention_mask=jnp.asarray(pre_mask),
                               cache=jc, cache_offset=0)
        pc = params_from_jax(jax.tree.map(np.asarray, jc))
        jl, jc = jqwen3.forward(jp, jcfg, input_ids=jnp.asarray(suf), attention_mask=jnp.asarray(am),
                                positions=jnp.asarray(pos), cache=jc, cache_offset=P)
        pl, pc = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(suf), attention_mask=torch.from_numpy(am),
                                positions=torch.from_numpy(pos), cache=pc, cache_offset=P)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        for name in ("k", "v"):
            got = pc[name][:, :, :, P:P + S].float().numpy()
            ref = np.asarray(jc[name]).astype(np.float32)[:, :, :, P:P + S]
            if kv == "int8":  # a value may round to the neighbouring integer
                assert np.abs(got - ref).max() <= 1 and (got != ref).mean() < 0.01
            else:
                np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_init_slot_state_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The slot state lands on the card unless the caller asks for the CPU."""
    gcfg = pengine.GenerationConfig(max_new_tokens=4, kv_dtype="int8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pslots.init_slot_state(pconfig.QWEN3_TINY, gcfg, 2, 16)
    state = pslots.init_slot_state(pconfig.QWEN3_TINY, gcfg, 2, 16, device="cpu")
    assert state["cache"]["k"].dtype == torch.int8 and state["out"].device.type == "cpu"


def test_mha_quantized_kv_matches_jax():
    """Both layouts, GQA groups of 2, a mask with a fully masked key run."""
    rng = np.random.default_rng(61)
    B, S, NH, NKV, T, D = 2, 3, 4, 2, 9, 16
    q = rng.standard_normal((B, S, NH, D)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, NKV, T, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, NKV, T, D)).astype(np.int8)
    ks = (rng.random((B, NKV, T)) * 0.02 + 0.001).astype(np.float32)
    vs = (rng.random((B, NKV, T)) * 0.02 + 0.001).astype(np.float32)
    mask = rng.random((B, 1, S, T)) < 0.7
    mask[:, :, :, 0] = True
    ks_b, vs_b = (jnp.asarray(x, jnp.bfloat16) for x in (ks, vs))
    pks, pvs = (params_from_jax({"x": np.asarray(x)})["x"] for x in (ks_b, vs_b))
    for heads_major in (True, False):
        perm = (lambda a: a) if heads_major else (lambda a: np.swapaxes(a, 1, 2))
        sperm = (lambda a: a) if heads_major else (lambda a: jnp.swapaxes(a, 1, 2))
        ref = jattention.mha_quantized_kv(jnp.asarray(q), jnp.asarray(perm(k8)), sperm(ks_b), jnp.asarray(perm(v8)),
                                          sperm(vs_b), mask=jnp.asarray(mask), kv_heads_major=heads_major)
        got = pattention.mha_quantized_kv(
            torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(perm(k8))),
            pks if heads_major else pks.transpose(1, 2), torch.from_numpy(np.ascontiguousarray(perm(v8))),
            pvs if heads_major else pvs.transpose(1, 2), mask=torch.from_numpy(mask), kv_heads_major=heads_major)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_quantize_vision_w8_matches_jax():
    """The W8 tower: the int8 values and scales of every block projection
    equal JAX's bit for bit, dense leaves stay shared, and the aggregator's
    output through quant.linear agrees with JAX's (1e-4)."""
    vcfg = jconfig.VGGT_TINY
    jv = jax.jit(jvggt.init_params, static_argnums=1, static_argnames="dtype")(
        jax.random.PRNGKey(3), vcfg, dtype="float32")
    jv = jax.tree.map(lambda a: a * 4.0 if a.ndim >= 2 else a, jv)
    pv = params_from_jax(jax.tree.map(np.asarray, jv))
    jq = jvlm.quantize_vision({"vision": jv}, mode="w8", donate=False)["vision"]
    pq = pvlm.quantize_vision({"vision": pv}, mode="w8", donate=False)["vision"]
    assert not isinstance(pv["frame_blocks"]["qkv_w"], dict)  # donate=False left the caller's tree
    for group in ("frame_blocks", "global_blocks"):
        for key in pvlm.VISION_BLOCK_QUANT_KEYS:
            np.testing.assert_array_equal(pq[group][key]["w8"].numpy(), np.asarray(jq[group][key]["w8"]))
            np.testing.assert_array_equal(pq[group][key]["scale"].view(torch.int16).numpy(),
                                          np.asarray(jq[group][key]["scale"]).view(np.int16))
    assert pq["patch"]["blocks"]["mlp_w2"]["w8"].dtype == torch.int8
    assert pq["patch"]["blocks"]["ln1_w"] is pv["patch"]["blocks"]["ln1_w"]
    images = np.random.default_rng(62).random((1, 2, 3, 56, 56)).astype(np.float32)
    (ref,), _ = jax.jit(jvggt.aggregator, static_argnums=1)(jq, vcfg, jnp.asarray(images))
    (got,), _ = pvggt.aggregator(pq, pconfig.VGGT_TINY, torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)
