"""The port's slot engine in speculative mode against the JAX package's:
the same schedules give the same tokens, lengths and scheduler statistics
(verify blocks, accepted tokens, the chunk at which the guard tripped), and
the tokens of JAX's ``engine.generate`` — plain prompt-lookup chunks with a
bf16 and an int8 cache (a request drafting its own continuation, a budget
of 2, a prefixed request over holed rows), chunks under the action-JSON
constraint, and the guard turning speculative chunks off. The schedules,
the weights and JAX's kernel routing are those of
``tests/test_torch_slots.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_slots import N, _held, _reference, _request, jax_kernels, model  # noqa: F401 (fixtures)
from vggt_qwen3_tpu.data.tokenizer import load_tokenizer as jload_tokenizer
from vggt_qwen3_tpu.inference import constrained as jcon
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer as pload_tokenizer
from vggt_qwen3_tpu_torch.inference import constrained as pcon


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_speculative_slots_match_jax(model, jax_kernels, kv):
    """Speculative chunks (k = 3, two verify blocks a chunk): a request
    whose draft memory holds its own continuation (drafts accepted), plain
    ones, a budget of 2; after five chunks (every one of them finished) a
    prefixed request and a plain one (verify blocks over holed rows). The
    prefixed one is held to JAX's SlotEngine only (see ``_held``)."""
    jcfg, _, jp, _ = model
    gen_kw = dict(max_new_tokens=N, pad_token_id=0)
    reqs = [_request(jp, 30 + i, S=8 + i) for i in range(3)]
    oracle = _reference(jp, jcfg, gen_kw, [("submit", reqs[0])])[0][0]
    reqs[0]["lookup"] = np.concatenate([reqs[0]["ids"], oracle[None].astype(np.int32)], axis=1)
    reqs[1]["lookup"] = reqs[1]["ids"]
    reqs[2]["budget"] = 2
    prefix = np.random.default_rng(6).integers(1, 512, (1, 5)).astype(np.int32)
    schedule = ([("submit", r) for r in reqs] + [("step", 5)]
                + [("prefix", prefix, np.asarray(jqwen3.embed_tokens(jp, jnp.asarray(prefix))))]
                + [("submit", _request(jp, 33, S=6, bucket=8, prefix=True)), ("submit", _request(jp, 34, S=9))])
    out, stats = _held(model, jax_kernels, kv, gen_kw, schedule, speculative=True, draft_k=3, spec_chunk=2,
                       spec_min_gain=0.5, exact=(0, 1, 2, 4))
    assert stats["spec_accepted"] > stats["spec_blocks"] > 0
    assert out[0] == (oracle.tolist(), N)


def test_speculative_slots_under_the_action_json_fsm_match_jax(model, jax_kernels):
    """The action-JSON constraint (byte tokenizer, vocab 512) over plain and
    speculative chunks, the draft memory seeded with the schema's text."""
    jp = model[2]
    ptable = pcon.action_json_constraint(pload_tokenizer(None), vocab_size=512)
    jtable = jnp.asarray(jcon.action_json_constraint(jload_tokenizer(None), vocab_size=512))
    hint = np.frombuffer(b'{"action": "place", "scene": "s"', np.uint8).astype(np.int32)
    reqs = []
    for i in range(3):
        r = _request(jp, 40 + i, S=7 + i)
        r["lookup"] = np.concatenate([hint[None], r["ids"]], axis=1)  # the byte tokenizer's ids are the bytes
        reqs.append(r)
    gen_kw = dict(max_new_tokens=N, pad_token_id=0, repetition_penalty=1.1, no_repeat_ngram=4)
    for spec in (False, True):
        out, stats = _held(model, jax_kernels, "int8", gen_kw, [("submit", r) for r in reqs], jconstraint=jtable,
                           pconstraint=ptable, speculative=spec, draft_k=3, spec_chunk=2, spec_min_gain=0.5)
        assert all(n == N for _, n in out) and bytes(out[0][0][:2]) == b'{"'
        assert (stats["spec_blocks"] > 0) == spec


def test_speculative_guard_trips_and_stays_token_exact(model, jax_kernels):
    """Penalty 1.3 and no-repeat-2 leave drafts no chance: the guard
    (window 3) turns speculative chunks off, at the chunk JAX's does, and
    the tokens stay those of engine.generate; a later request is served by
    plain chunks."""
    jp = model[2]
    schedule = [("submit", _request(jp, 50, S=10)), ("submit", _request(jp, 51, S=9)), ("step", 3),
                ("submit", _request(jp, 52, S=8))]
    out, stats = _held(model, jax_kernels, "int8", dict(max_new_tokens=N, pad_token_id=0, repetition_penalty=1.3,
                                                        no_repeat_ngram=2), schedule,
                       speculative=True, draft_k=3, spec_chunk=1, spec_min_gain=1.35, spec_guard_window=3)
    assert stats["spec_disabled_at"] is not None and all(n == N for _, n in out)


