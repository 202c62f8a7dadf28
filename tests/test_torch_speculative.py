"""The port's constrained decoding and prompt-lookup speculative decoding
against the JAX package.

- ``inference/constrained.py``: the DFA accepts and rejects what JAX's does,
  and the compiled tables equal JAX's bit for bit (byte tokenizer, vocab 512
  and 151,936).
- ``draft_lookup`` equals JAX's on random histories.
- ``engine`` under the action-JSON constraint (penalty 1.1, no-repeat-4
  n-grams, as the ARKit CLI decodes) and with per-row budgets equals JAX's
  ``generate`` / ``generate_early_exit``.
- ``generate_speculative`` equals JAX's (tokens, lengths, iterations) with
  and without processors, with EOS, per-row budgets, a constraint and the
  int8 cache, and equals the port's own ``generate``.

Weights are JAX's (float32, scaled so attention moves the logits), inputs
numpy-seeded, both sides fed the same embeddings. The JAX prefill is routed
through its flash kernel in interpret mode, the path it takes on the TPU.
Tokens and iteration counts must be identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.data.tokenizer import load_tokenizer as jload_tokenizer
from vggt_qwen3_tpu.inference import constrained as jcon
from vggt_qwen3_tpu.inference import engine as jengine
from vggt_qwen3_tpu.inference import speculative as jspec
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer as pload_tokenizer
from vggt_qwen3_tpu_torch.inference import constrained as pcon
from vggt_qwen3_tpu_torch.inference import engine as pengine
from vggt_qwen3_tpu_torch.inference import speculative as pspec
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

CFG = dict(vocab_size=160, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
           intermediate_size=128, rope_theta=10_000.0, dtype="float32")
SCHEMA_KEYS = ["action", "scene", "center", "normal", "extent"]


@pytest.fixture
def jax_flash_prefill(monkeypatch):
    """Route the JAX Qwen3 prefill through its flash kernel (interpret mode)."""
    def attend(q, k, v, *, causal=False, kv_start=None, kv_end=None):
        return jax_flash(q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, interpret=True)

    jax.clear_caches()
    monkeypatch.setattr(jqwen3, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jqwen3, "attend", attend)
    yield
    jax.clear_caches()


def _model(cfg_kw, seed=3, mult=4.0):
    jcfg = jconfig.Qwen3Config(**cfg_kw)
    jp = jqwen3.init_params(jax.random.PRNGKey(seed), jcfg, dtype="float32")
    jp = jax.tree.map(lambda a: a * mult if a.ndim >= 2 else a, jp)
    return jcfg, pconfig.Qwen3Config(**cfg_kw), jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def model():
    return _model(CFG)


def _prompt(jp, seed, B=3, S=9, left_pad=3, vocab=160):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    ids[0, :left_pad] = 0
    mask[0, :left_pad] = 0
    emb = np.array(jqwen3.embed_tokens(jp, jnp.asarray(ids)))
    return ids, mask, emb


# ---------------------------------------------------------------------------
# the action-JSON DFA and its token tables
# ---------------------------------------------------------------------------


def _dfa_accepts(dfa, text: str) -> bool:
    state = 0
    for ch in text:
        state = dfa.trans[state].get(ch)
        if state is None:
            return False
    return state in dfa.accept


@pytest.mark.parametrize("text,ok", [
    (json.dumps({"action": "place_table", "scene": "room_01", "center": [1.0, -2.5, 0.0],
                 "normal": [0, 1, 0], "extent": [2, 1, 0.5]}), True),
    (json.dumps({"action": "x", "scene": "", "center": [0.5e3, 1e-2, -0.0], "normal": [1, 2, 3],
                 "extent": [4, 5, 6]}), True),
    ('{"action": "place_table", "scene": "room_01", "center": [1.0, -2.5, 0.0], '
     '"normal": [0, 1, 0], "center_x": 0}', False),  # wrong key
    ('{"action": "a", "scene": "s", "center": [1, 2], "normal": [0, 1, 0], "extent": [1, 1, 1]}', False),
    ('{"scene": "s", "action": "a", "center": [1, 2, 3], "normal": [0, 1, 0], "extent": [1, 1, 1]}', False),
    ('{"action": "a", "scene": "s", "center": [1, 2, 3], "normal": [0, 1, 0], "extent": [1, 1, 1]', False),
    ('{"action": 5, "scene": "s", "center": [1, 2, 3], "normal": [0, 1, 0], "extent": [1, 1, 1]}', False),
    ('{"action": "a", "scene": "s", "center": [007, 2, 3], "normal": [0, 1, 0], "extent": [1, 1, 1]}', False),
])
def test_dfa_accepts_and_rejects_as_jax_does(text, ok):
    assert _dfa_accepts(pcon.build_action_json_dfa(), text) is ok
    assert _dfa_accepts(jcon.build_action_json_dfa(), text) is ok
    assert pcon.build_action_json_dfa().trans == jcon.build_action_json_dfa().trans


@pytest.mark.parametrize("vocab_size", [512, 151936])
def test_constraint_table_is_bit_identical_to_jax(vocab_size):
    got = pcon.action_json_constraint(pload_tokenizer(None), vocab_size=vocab_size)
    ref = jcon.action_json_constraint(jload_tokenizer(None), vocab_size=vocab_size)
    assert got.dtype == ref.dtype == np.int16 and got.shape == ref.shape
    assert got.shape[1] == vocab_size
    np.testing.assert_array_equal(got, ref)


def test_constraint_table_rejects_a_tokenizer_that_cannot_close_a_string():
    """A reachable state with no allowed token (no '"' in the vocab) raises
    instead of letting greedy emit token 0 and the FSM reset."""
    class NoQuote:
        eos_token_id, pad_token_id = 3, 3

        def __len__(self):
            return 4

        def decode(self, ids, skip_special_tokens=True):
            return {0: "{", 1: "a", 2: "b", 3: ""}[ids[0]]

    with pytest.raises(ValueError, match="no allowed token"):
        pcon.compile_constraint_table(NoQuote())


# ---------------------------------------------------------------------------
# draft lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ngram,k", [(2, 4), (3, 6), (1, 3)])
def test_draft_lookup_matches_jax(ngram, k):
    rng = np.random.default_rng(ngram * 10 + k)
    B, C = 16, 40
    buf = rng.integers(0, 4, (B, C)).astype(np.int32)  # 4 symbols: many matches
    start = rng.integers(0, 10, (B,)).astype(np.int32)
    length = rng.integers(0, C + 1, (B,)).astype(np.int32)
    length = np.maximum(length, start)
    tok0 = rng.integers(0, 4, (B,)).astype(np.int32)
    ref = np.asarray(jspec.draft_lookup(*(jnp.asarray(a) for a in (buf, start, length, tok0)), k, ngram))
    got = pspec.draft_lookup(*(torch.from_numpy(a) for a in (buf, start, length, tok0)), k, ngram)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != 0).any()


# ---------------------------------------------------------------------------
# the engine under a constraint, with budgets
# ---------------------------------------------------------------------------


def test_engine_under_the_action_json_constraint_matches_jax(jax_flash_prefill):
    """The ARKit decode: penalty 1.1, no-repeat-4 n-grams, the action-JSON
    table; every row closes its object and parses. With per-row budgets the
    early-exit engine stops each row where JAX's does."""
    cfg_kw = dict(dataclasses.asdict(jconfig.QWEN3_TINY), dtype="float32")
    jcfg, pcfg, jp, pp = _model(cfg_kw, seed=0, mult=2.0)
    tok = pload_tokenizer(None)
    table = pcon.action_json_constraint(tok, vocab_size=jcfg.vocab_size)
    ids, mask, emb = _prompt(jp, 7, B=4, S=12, left_pad=2, vocab=len(tok) - 2)
    kw = dict(max_new_tokens=340, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
              repetition_penalty=1.1, no_repeat_ngram=4)
    jt, jl = jengine.generate(jp, jcfg, jengine.GenerationConfig(**kw), inputs_embeds=jnp.asarray(emb),
                              attention_mask=jnp.asarray(mask), constraint=jnp.asarray(table))
    gcfg = pengine.GenerationConfig(**kw)
    pt, plen = pengine.generate(pp, pcfg, gcfg, inputs_embeds=torch.from_numpy(emb),
                                attention_mask=torch.from_numpy(mask), constraint=torch.from_numpy(table))
    np.testing.assert_array_equal(pt, np.asarray(jt))
    np.testing.assert_array_equal(plen, np.asarray(jl))
    for row, n in zip(pt, plen):
        assert list(json.loads(tok.decode(row[:n], skip_special_tokens=True))) == SCHEMA_KEYS

    budget = np.array([40, 1, 300, 17], np.int32)
    jt, jl, jsteps = jengine.generate_early_exit(
        jp, jcfg, jengine.GenerationConfig(**kw), inputs_embeds=jnp.asarray(emb),
        attention_mask=jnp.asarray(mask), constraint=jnp.asarray(table), budget=budget)
    et, elen, steps = pengine.generate_early_exit(
        pp, pcfg, gcfg, inputs_embeds=torch.from_numpy(emb), attention_mask=torch.from_numpy(mask),
        constraint=torch.from_numpy(table), budget=budget)
    np.testing.assert_array_equal(et, np.asarray(jt))
    np.testing.assert_array_equal(elen, np.asarray(jl))
    assert steps == jsteps and elen.tolist()[:2] == [40, 1] and elen[3] == 17
    np.testing.assert_array_equal(et[2], pt[2])  # a budget above the object's length changes nothing


@pytest.mark.parametrize("call", [pengine.generate_early_exit, pspec.generate_speculative])
def test_budgets_below_one_raise(model, call):
    _, pcfg, jp, pp = model
    ids, mask, emb = _prompt(jp, 0)
    with pytest.raises(ValueError, match="budgets must be >= 1"):
        call(pp, pcfg, pengine.GenerationConfig(max_new_tokens=4), inputs_embeds=torch.from_numpy(emb),
             attention_mask=torch.from_numpy(mask), budget=np.array([2, 0, 1]))


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------


def _cycle_table(vocab):
    """A one-token-per-state cyclic FSM: output repeats, drafts hit."""
    cycle = [7, 23, 5, 41]
    table = np.full((len(cycle), vocab), -1, np.int16)
    for s, t in enumerate(cycle):
        table[s, t] = (s + 1) % len(cycle)
    return table


SPEC_CASES = {
    "plain": dict(gen=dict(max_new_tokens=16, pad_token_id=0)),
    "processors": dict(gen=dict(max_new_tokens=18, repetition_penalty=1.1, no_repeat_ngram=3, pad_token_id=0)),
    "eos": dict(gen=dict(max_new_tokens=20, pad_token_id=0), eos_at=5),
    "budget": dict(gen=dict(max_new_tokens=16, pad_token_id=0), budget=[6, 3, 16]),
    "constraint": dict(gen=dict(max_new_tokens=24, pad_token_id=0, repetition_penalty=1.1), table=True, k=4),
    "int8": dict(gen=dict(max_new_tokens=12, pad_token_id=0, kv_dtype="int8")),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_generate_speculative_matches_jax_and_generate(case, model, jax_flash_prefill):
    c = SPEC_CASES[case]
    jcfg, pcfg, jp, pp = model
    ids, mask, emb = _prompt(jp, sorted(SPEC_CASES).index(case))
    gen = dict(c["gen"])
    if "eos_at" in c:  # a token that row 0 emits at that step
        free, _ = pengine.generate(pp, pcfg, pengine.GenerationConfig(**gen), inputs_embeds=torch.from_numpy(emb),
                                   attention_mask=torch.from_numpy(mask))
        gen["eos_token_id"] = int(free[0, c["eos_at"]])
    table = _cycle_table(jcfg.vocab_size) if c.get("table") else None
    budget = np.array(c["budget"], np.int32) if "budget" in c else None
    k = c.get("k", 4)
    jt, jl, jiters = jspec.generate_speculative(
        jp, jcfg, jengine.GenerationConfig(**gen), inputs_embeds=jnp.asarray(emb),
        attention_mask=jnp.asarray(mask), prompt_ids=jnp.asarray(ids), budget=budget, draft_k=k, ngram=3,
        constraint=None if table is None else jnp.asarray(table.astype(np.int32)))
    pkw = dict(inputs_embeds=torch.from_numpy(emb), attention_mask=torch.from_numpy(mask),
               constraint=None if table is None else torch.from_numpy(table))
    gcfg = pengine.GenerationConfig(**gen)
    pt, plen, piters = pspec.generate_speculative(pp, pcfg, gcfg, prompt_ids=torch.from_numpy(ids), budget=budget,
                                                  draft_k=k, ngram=3, **pkw)
    np.testing.assert_array_equal(pt, np.asarray(jt))
    np.testing.assert_array_equal(plen, np.asarray(jl))
    assert piters == jiters
    # and the port's own generate (the early-exit engine where budgets apply)
    if budget is None:
        gt, gl = pengine.generate(pp, pcfg, gcfg, **pkw)
    else:
        gt, gl, _ = pengine.generate_early_exit(pp, pcfg, gcfg, budget=budget, **pkw)
    np.testing.assert_array_equal(pt, gt)
    np.testing.assert_array_equal(plen, gl)
    if case == "constraint":  # after one cycle the lookup drafts everything
        assert piters <= 12, piters
    if case == "eos":
        assert plen[0] == c["eos_at"] + 1


def test_generate_speculative_with_w8_weights_matches_generate(model):
    """W8 serving weights: verify blocks run the fused W8 layer kernels'
    plain versions over B·(k+1) rows, decode steps over B rows; the tokens
    are the same."""
    from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3

    _, pcfg, jp, pp = model
    w8 = pqwen3.quantize_params({k: ({n: t.bfloat16() for n, t in v.items()} if isinstance(v, dict) else v.bfloat16())
                                 for k, v in pp.items()}, donate=False)
    assert all(isinstance(w8["layers"][k], dict) for k in pqwen3.QUANTIZED_LAYER_KEYS)
    ids, mask, _ = _prompt(jp, 11)
    emb = pqwen3.embed_tokens(w8, torch.from_numpy(ids))
    gcfg = pengine.GenerationConfig(max_new_tokens=16, pad_token_id=0, repetition_penalty=1.1, kv_dtype="int8")
    kw = dict(inputs_embeds=emb, attention_mask=torch.from_numpy(mask))
    gt, gl = pengine.generate(w8, pcfg, gcfg, **kw)
    st, sl, iters = pspec.generate_speculative(w8, pcfg, gcfg, prompt_ids=torch.from_numpy(ids), **kw)
    np.testing.assert_array_equal(st, gt)
    np.testing.assert_array_equal(sl, gl)
    assert 1 <= iters <= 16
