"""The port's small ops against the JAX package's: norms, RoPE, 2-D RoPE,
logit processors, preprocessing and the int8 KV quantiser. Inputs come
from a numpy seed and go to both sides. Tolerances: float32 ops 1e-6
(same formula, same order up to reassociation), preprocessing 1/255 (one
uint8 rounding step may land on the other side), quantised values exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.ops import norms as jnorms
from vggt_qwen3_tpu.ops import preprocess as jpre
from vggt_qwen3_tpu.ops import rope as jrope
from vggt_qwen3_tpu.ops import rope2d as jrope2d
from vggt_qwen3_tpu.ops import sampling as jsampling
from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3
from vggt_qwen3_tpu_torch.ops import norms as pnorms
from vggt_qwen3_tpu_torch.ops import preprocess as ppre
from vggt_qwen3_tpu_torch.ops import rope as prope
from vggt_qwen3_tpu_torch.ops import rope2d as prope2d
from vggt_qwen3_tpu_torch.ops import sampling as psampling


def _r(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, ref, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol, rtol=tol)


def test_norms_match():
    x, w, b = _r((3, 5, 48), 0, 3.0), _r((48,), 1), _r((48,), 2)
    _close(pnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    _close(pnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5), 2e-6)


def test_rope_matches():
    pos = np.array([[0, 1, 2, 7], [3, 3, 4, 900]], np.int32)
    x = _r((2, 4, 3, 32))
    cj, sj = jrope.rope_cos_sin(jnp.asarray(pos), 32, 5e6)
    ct, st = prope.rope_cos_sin(torch.from_numpy(pos), 32, 5e6)
    _close(ct, cj)
    _close(st, sj)
    _close(prope.apply_rope(torch.from_numpy(x), ct, st), jrope.apply_rope(jnp.asarray(x), cj, sj), 2e-6)


def test_rope2d_matches():
    coords = np.array([[[0, 0], [1, 1], [1, 2], [5, 3]]], np.int32)
    x = _r((1, 4, 2, 64))
    cj, sj = jrope2d.rope2d_cos_sin(jnp.asarray(coords), 64, 100.0)
    ct, st = prope2d.rope2d_cos_sin(torch.from_numpy(coords), 64, 100.0)
    _close(ct, cj)
    _close(st, sj)
    _close(prope2d.apply_rope2d(torch.from_numpy(x), ct, st, None),
           jrope2d.apply_rope2d(jnp.asarray(x), cj, sj, None), 2e-6)


@pytest.mark.parametrize("penalty,ngram", [(1.1, 0), (1.0, 3), (1.3, 2)])
def test_logit_processors_match(penalty, ngram):
    rng = np.random.default_rng(3)
    B, V, T = 3, 40, 12
    logits = rng.standard_normal((B, V)).astype(np.float32)
    seen = rng.integers(0, 6, (B, T)).astype(np.int32)  # few ids → many repeats
    seen_len = np.array([0, 5, 12], np.int32)
    ref = jsampling.apply_no_repeat_ngram(
        jsampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(seen_len), penalty),
        jnp.asarray(seen), jnp.asarray(seen_len), ngram)
    got = psampling.apply_no_repeat_ngram(
        psampling.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(seen),
                                           torch.from_numpy(seen_len), penalty),
        torch.from_numpy(seen), torch.from_numpy(seen_len), ngram)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(psampling.greedy_token(got).numpy(), np.asarray(jsampling.greedy_token(ref)))


@pytest.mark.parametrize("shape,size", [((96, 96, 3), 56), ((60, 90, 3), 56), ((120, 80, 3), 48), ((30, 40, 3), 56)])
def test_preprocess_matches(shape, size):
    img = np.random.default_rng(4).integers(0, 256, shape).astype(np.uint8)
    ref = np.asarray(jpre.resize_center_crop(img, size))
    got = ppre.resize_center_crop(img, size, "cpu").numpy()
    assert got.shape == ref.shape == (3, size, size)
    np.testing.assert_allclose(got, ref, atol=1 / 255 + 1e-6, rtol=0)


def test_quantize_kv_matches():
    x = _r((2, 5, 3, 16), 5, 2.0)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    qj, sj = jqwen3._quantize_kv(jnp.asarray(x))
    qt, st = pqwen3._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.float().numpy(), np.asarray(sj, np.float32))
