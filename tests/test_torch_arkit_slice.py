"""The whole ARKit action-JSON slice: the port's ``arkit.run_inference``
against the JAX package's on the ``--tiny`` stage of
``configs/stage2_arkit.yaml`` (real tiny VGGT, Perceiver, Qwen3; float32),
over the 4 ARKit test scenes with 10 views each, the same decoded images and
the same weights, with the action-JSON constraint, without and with
prompt-lookup speculative decoding. Generated tokens and records must be
identical, and every generation parses to the schema's keys.

JAX runs the path it takes on the TPU, its Pallas kernels in interpret
mode: the prefill through the flash kernel (as ``tests/test_torch_qa_slice.py``
does), decode steps and verify blocks through ``gqa_decode_attention`` and
``gqa_block_verify_attention``. The tiny stage's text config keeps a bf16
cache under float32 weights, and there JAX's CPU-only XLA attention rounds P
to bf16, which neither the TPU kernel nor the port does (they keep it f32).
"""

import argparse
import json

import jax
import numpy as np
import pytest

from vggt_qwen3_tpu.data.tokenizer import load_tokenizer as jload_tokenizer
from vggt_qwen3_tpu.inference import arkit as jarkit
from vggt_qwen3_tpu.ops import decode_attention as jdecode
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer as pload_tokenizer
from vggt_qwen3_tpu_torch.inference import arkit as parkit
from vggt_qwen3_tpu_torch.inference import qa as pqa
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

MAX_NEW = 340  # every constrained object closes within 340 byte tokens
SCHEMA_KEYS = ["action", "scene", "center", "normal", "extent"]


@pytest.fixture(scope="module")
def setup():
    args = argparse.Namespace(config="configs/stage2_arkit.yaml", tiny=True, mock_vision=False,
                              checkpoint_dir=None)
    jstage = jarkit.build_stage(args)
    pstage = pqa.build_stage(args)
    assert pstage.model.vision is not None and pstage.data.num_views == 10
    jparams = jarkit.load_model(jstage, None, rng_seed=0)
    # 8x the init scale, so that attention over the cache moves the tokens
    jparams = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a, jparams)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    samples = parkit.load_arkit_samples("data/processed/arkit_synth/test.json", 9, pstage.data.num_views,
                                        pstage.data.image_size)
    assert len(samples) == 4 and all(len(s["images"]) == 10 for s in samples)
    return jstage, pstage, jparams, pparams, samples


def _capture(monkeypatch, module):
    """Record the tokens each generate_batch call returns."""
    seen = []
    real = module.generate_batch

    def wrapped(*a, **kw):
        tokens, lengths = real(*a, **kw)
        seen.append((np.asarray(tokens), np.asarray(lengths)))
        return tokens, lengths

    monkeypatch.setattr(module, "generate_batch", wrapped)
    return seen


@pytest.mark.parametrize("speculative", [False, True])
def test_arkit_slice_records_identical(setup, speculative, monkeypatch):
    jstage, pstage, jparams, pparams, samples = setup

    def attend(q, k, v, *, causal=False, kv_start=None, kv_end=None):
        return jax_flash(q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, interpret=True)

    jax.clear_caches()
    monkeypatch.setattr(jqwen3, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jqwen3, "attend", attend)
    monkeypatch.setenv("VGGT_DECODE_KERNEL", "force")  # the decode kernels in interpret mode
    monkeypatch.setattr(jdecode, "decode_attention_eligible", lambda *a: True)
    j_tok = _capture(monkeypatch, jarkit)
    p_tok = _capture(monkeypatch, parkit)
    kw = dict(max_new_tokens=MAX_NEW, constrained_json=True, speculative=speculative, verbose=False)
    jres, jm = jarkit.run_inference(jparams, jstage, jload_tokenizer(None), samples, **kw)
    pres, pm = parkit.run_inference(pparams, pstage, pload_tokenizer(None), samples, device="cpu", **kw)
    jax.clear_caches()

    assert len(j_tok) == len(p_tok) == 1
    np.testing.assert_array_equal(p_tok[0][0], j_tok[0][0])
    np.testing.assert_array_equal(p_tok[0][1], j_tok[0][1])
    assert pres == jres and pm == jm
    # every generation is a schema object (the FSM's guarantee); the records'
    # raw_prediction is the reference's quote-unaware brace match, which a
    # '}' inside a random string value cuts short
    tok = pload_tokenizer(None)
    for row, n in zip(*p_tok[0]):
        assert list(json.loads(tok.decode(row[:n], skip_special_tokens=True))) == SCHEMA_KEYS


@pytest.mark.parametrize("text", [
    'You are a RoomPlan assistant. {"action": "a", "scene": "s"} tail',
    'Instruction: put a lamp\n{"action": "x}y", "scene": "{"} and {"b": 1}',
    "no json here",
    '{"unclosed": [1, 2',
    "<image> {\"a\": {\"b\": {}}} <image>",
])
def test_arkit_postprocess_matches_jax(text):
    from vggt_qwen3_tpu.inference import postprocess as jpost
    from vggt_qwen3_tpu_torch.inference import postprocess as ppost

    prompt = parkit.prompt_for("put a lamp")
    for question in ("put a lamp", "You are a RoomPlan assistant."):
        got = ppost.postprocess_arkit_generation(text, prompt, question)
        assert got == jpost.postprocess_arkit_generation(text, prompt, question)
        assert ppost.extract_first_json(got) == jpost.extract_first_json(got)
    assert parkit.SYSTEM_HINT == jarkit.SYSTEM_HINT


def test_arkit_run_inference_defaults_to_cuda_and_raises_without_it(setup, monkeypatch):
    import torch

    _, pstage, _, pparams, samples = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parkit.run_inference(pparams, pstage, pload_tokenizer(None), samples[:1], max_new_tokens=2)
