"""The whole QA slice: the port's ``run_inference`` against the JAX
package's on the ``--tiny`` stage of ``qa.build_stage`` (real tiny VGGT,
Perceiver, Qwen3; float32), over the 8 placeholder ScanQA samples with the
same decoded images and the same weights. Generated tokens and predictions
must be identical, with the model-dtype cache and with the int8 cache.

The JAX prefill is routed through its Pallas flash kernel in interpret mode,
the path it takes on the TPU (on the CPU backend JAX would attend over the
whole cache with XLA instead; for the int8 cache that is attention over
dequantised K/V, a different function). Decode steps run through JAX's plain
XLA reference, the same numerics as the decode kernel in float32.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu.inference import qa as jqa
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.data.tokenizer import load_tokenizer as jload_tokenizer
from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu_torch.data.dataset import DatasetConfig, MultiViewJsonDataset
from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer as pload_tokenizer
from vggt_qwen3_tpu_torch.inference import qa as pqa
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

MAX_NEW = 10


def _args():
    return argparse.Namespace(config="configs/stage1_3d.yaml", tiny=True, mock_vision=False,
                              checkpoint_dir=None)


@pytest.fixture(scope="module")
def setup():
    jstage = jqa.build_stage(_args())
    pstage = pqa.build_stage(_args())
    assert pstage.model.vision is not None and pstage.model.dtype == "float32"
    jparams = jqa.load_model(jstage, None, rng_seed=0)
    # at the init scale (0.02) attention barely moves the greedy tokens, so a
    # wrong mask would go unseen; 8x larger matrices make every layer count
    jparams = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a, jparams)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    ds = MultiViewJsonDataset(DatasetConfig(
        path_glob="data/processed/scanqa/test_split.jsonl", num_views=jstage.data.num_views,
        image_size=jstage.data.image_size, task="qa",
    ))
    samples = [ds[i] for i in range(len(ds))]
    assert len(samples) == 8 and all(len(s["images"]) == 8 for s in samples)
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


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_qa_slice_tokens_and_predictions_identical(setup, kv_dtype, monkeypatch):
    jstage, pstage, jparams, pparams, samples = setup

    def attend(q, k, v, *, causal=False, kv_start=None, kv_end=None):
        return jax_flash(q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, interpret=True)

    jax.clear_caches()
    monkeypatch.setattr(jqwen3, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jqwen3, "attend", attend)
    j_tok = _capture(monkeypatch, jqa)
    p_tok = _capture(monkeypatch, pqa)

    jres = jqa.run_inference(jparams, jstage, jload_tokenizer(None), samples, max_new_tokens=MAX_NEW,
                             batch_size=8, kv_dtype=kv_dtype, verbose=False)
    pres = pqa.run_inference(pparams, pstage, pload_tokenizer(None), samples, max_new_tokens=MAX_NEW,
                             batch_size=8, kv_dtype=kv_dtype, verbose=False, device="cpu")
    jax.clear_caches()

    assert len(j_tok) == len(p_tok) == 1
    np.testing.assert_array_equal(p_tok[0][0], j_tok[0][0])
    np.testing.assert_array_equal(p_tok[0][1], j_tok[0][1])
    assert (p_tok[0][1] > 0).all()
    assert pres == jres


def test_qa_slice_speculative_matches_jax(setup, monkeypatch):
    """``run_inference(speculative=True)``: the port's prompt-lookup
    speculative decoding against JAX's on the same slice, JAX's decode
    steps and verify blocks in its Pallas kernels (interpret mode) as on the
    TPU: the tiny stage keeps a bf16 cache under float32 weights, where JAX's
    CPU-only XLA attention rounds P to bf16 and the kernels do not."""
    from vggt_qwen3_tpu.ops import decode_attention as jdecode

    jstage, pstage, jparams, pparams, samples = setup

    def attend(q, k, v, *, causal=False, kv_start=None, kv_end=None):
        return jax_flash(q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, interpret=True)

    jax.clear_caches()
    monkeypatch.setattr(jqwen3, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jqwen3, "attend", attend)
    monkeypatch.setenv("VGGT_DECODE_KERNEL", "force")
    monkeypatch.setattr(jdecode, "decode_attention_eligible", lambda *a: True)
    j_tok = _capture(monkeypatch, jqa)
    p_tok = _capture(monkeypatch, pqa)
    kw = dict(max_new_tokens=MAX_NEW, batch_size=8, verbose=False, speculative=True)
    jres = jqa.run_inference(jparams, jstage, jload_tokenizer(None), samples, **kw)
    pres = pqa.run_inference(pparams, pstage, pload_tokenizer(None), samples, device="cpu", **kw)
    plain = pqa.run_inference(pparams, pstage, pload_tokenizer(None), samples, device="cpu",
                              **dict(kw, speculative=False))
    jax.clear_caches()

    np.testing.assert_array_equal(p_tok[0][0], j_tok[0][0])
    np.testing.assert_array_equal(p_tok[0][1], j_tok[0][1])
    np.testing.assert_array_equal(p_tok[0][0], p_tok[1][0])  # the port's own plain decode
    assert pres == jres == plain
