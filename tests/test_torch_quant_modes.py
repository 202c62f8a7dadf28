"""The W8A8 and W4 modes of the port (``ops/quant.py``, ``qwen3.quantize_params``,
``vlm.quantize_vision``) against the JAX package's, at tiny widths.

The quantizers and the W8A8 product are held bit for bit to JAX's **jitted**
functions (XLA compiles ``/ 127.0`` and ``/ 7.0`` to products with the f32
reciprocals, as the port writes them; an eager JAX call divides). The W4
product is two matmuls over dequantized bf16 halves, held to 1e-5 of
JAX's (f32 activations; bf16 activations within one bf16 step). Decode steps over W8A8 and W4
layers must not reach the fused W8 kernels (kernels 4–6), and ``generate_text``
gives JAX's tokens in both modes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.inference import engine as jengine
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.models import vggt as jvggt
from vggt_qwen3_tpu.models import vlm as jvlm
from vggt_qwen3_tpu.ops import quant as jquant
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.inference import engine as pengine
from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3
from vggt_qwen3_tpu_torch.models import vggt as pvggt
from vggt_qwen3_tpu_torch.models import vlm as pvlm
from vggt_qwen3_tpu_torch.ops import quant as pquant
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

from tests.test_torch_decode_matmul import _assert_same_tree, _bits, _jbits
from tests.test_torch_models import jax_flash_prefill, port_cfg, to_np  # noqa: F401  (a fixture)

FUSED = ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8")


def _bf16(a: np.ndarray):
    """(the port's bf16 tensor, JAX's bf16 array) of the same values."""
    t = torch.from_numpy(a).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("rows", [1, 8, 17, 40])
def test_w8a8_linear_and_activation_quantizer_bit_identical(rows):
    """Per-row activation quantization (int8 values and f32 scales) and the
    W8A8 product, bf16 and f32 activations, equal JAX's jitted ones bit for
    bit; the row counts cover the card's zero-padded products (≤ 16 rows)."""
    rng = np.random.default_rng(rows)
    x = (rng.standard_normal((rows, 96)) * rng.uniform(0.05, 20, (rows, 1))).astype(np.float32)
    x[0, :] = 0.0  # an all-zero row: the 1e-8 clamp
    w = rng.standard_normal((96, 40)).astype(np.float32)
    px, jx = _bf16(x)
    p8, ps = pquant.quantize_activations(px)
    j8, js = jax.jit(jquant.quantize_activations)(jx)
    np.testing.assert_array_equal(p8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    pw = pquant.mark_act_quant(pquant.quantize_per_channel(torch.from_numpy(w)))
    jw = jquant.mark_act_quant(jax.jit(jquant.quantize_per_channel)(jnp.asarray(w)))
    _assert_same_tree(pw, jw)
    for xp, xj in ((px, jx), (torch.from_numpy(x), jnp.asarray(x))):
        got = pquant.linear(xp, pw)
        ref = jax.jit(jquant.linear)(xj, jw)
        assert got.dtype == xp.dtype
        np.testing.assert_array_equal(_bits(got), _jbits(ref))
    # a leading batch axis folds into the rows, as in JAX
    got3 = pquant.linear(px.reshape(1, rows, 96), pw)
    np.testing.assert_array_equal(_bits(got3[0]), _bits(pquant.linear(px, pw)))
    np.testing.assert_array_equal(pquant.int8_matmul(p8, pw["w8"]).numpy(),
                                  p8.int().numpy() @ pw["w8"].int().numpy())


def test_w4_nibbles_and_packing_bit_identical():
    """Every byte value unpacks to JAX's two nibbles (all 16 of each half);
    the packer equals JAX's jitted one at the full group (K = 512) and the
    tiny-width group (K = 16 → group 8), and the stacked quantizer (a layer
    at a time) equals JAX's ``lax.map``."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)  # K = 4, N = 128
    gscale = np.ones((2, 128), np.float32)
    plo, phi = pquant._w4_halves(torch.from_numpy(packed), torch.from_numpy(gscale).bfloat16())
    jlo, jhi = jquant._w4_halves(jnp.asarray(packed), jnp.asarray(gscale).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(plo), _jbits(jlo))
    np.testing.assert_array_equal(_bits(phi), _jbits(jhi))
    assert set(plo.float().unique().tolist()) == set(phi.float().unique().tolist()) == set(range(-8, 8))
    rng = np.random.default_rng(4)
    for K, N in ((512, 24), (16, 8)):
        w = rng.standard_normal((K, N)).astype(np.float32)
        w[:, 0] = 0.0  # a zero channel: the 1e-8 clamp
        got = pquant.quantize_per_group_w4(torch.from_numpy(w))
        ref = jax.jit(jquant.quantize_per_group_w4)(jnp.asarray(w))
        _assert_same_tree(got, ref)
        assert got["gscale"].shape[0] == (4 if K == 512 else 2)
        np.testing.assert_array_equal(_bits(pquant.dequantize(got)), _jbits(jax.jit(jquant.dequantize)(ref)))
    w = rng.standard_normal((3, 64, 16)).astype(np.float32)
    _assert_same_tree(pquant.quantize_stacked_w4(torch.from_numpy(w)),
                      jax.jit(lambda a: jax.lax.map(jquant.quantize_per_group_w4, a))(jnp.asarray(w)))
    with pytest.raises(ValueError, match="W4 needs"):
        pquant.quantize_per_group_w4(torch.ones(5, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4_linear_within_tolerance(dtype):
    """Two matmuls over the dequantized halves: f32 activations within 1e-5
    of JAX's (reassociation), bf16 within one bf16 step of the output's scale
    (each half's product is rounded before the sum, on both sides)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    pw = pquant.quantize_per_group_w4(torch.from_numpy(w))
    jw = jax.jit(jquant.quantize_per_group_w4)(jnp.asarray(w))
    if dtype == "float32":
        px, jx, tol = torch.from_numpy(x), jnp.asarray(x), 1e-5
    else:
        (px, jx), tol = _bf16(x), None
    got = pquant.linear(px, pw).float().numpy()
    ref = np.asarray(jax.jit(jquant.linear)(jx, jw).astype(jnp.float32))
    if tol is None:
        tol = 2 * 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("mode,tied", [("w8a8", True), ("w8a8", False), ("w4", True), ("w4", False)])
def test_quantize_params_trees_bit_identical(mode, tied):
    """Layer projections W8A8 (the marker kept per layer) or W4 (packed a
    layer at a time); the embedding W8 rows and an untied head per-channel
    W8 in every mode: every leaf equals JAX's bit for bit. The W8A8 matrices
    are channel-major views (the card's int8 GEMM layout) of the same values."""
    cfg = dataclasses.replace(jconfig.QWEN3_TINY, tie_word_embeddings=tied)
    jp = jqwen3.init_params(jax.random.PRNGKey(6), cfg)
    ref = jqwen3.quantize_params(jp, donate=False, mode=mode)
    pp = params_from_jax(to_np(jp))
    got = pqwen3.quantize_params(pp, donate=False, mode=mode)
    _assert_same_tree(got, ref)
    assert not isinstance(pp["layers"]["wq"], dict)
    if mode == "w8a8":
        w8 = got["layers"]["gate"]["w8"]
        assert w8.stride()[1:] == (1, w8.shape[1]) and got["layers"]["gate"]["a8"].shape == (cfg.num_layers, 0)
    assert pquant.is_plain_w8(got["embed"]) and (tied or pquant.is_plain_w8(got["lm_head"]))
    with pytest.raises(ValueError, match="quantize mode"):
        pqwen3.quantize_params(pp, donate=False, mode="w2")


def test_quantize_vision_w8a8_matches_jax():
    """The W8A8 tower: every block projection's int8 values, scales and
    marker equal JAX's, and the aggregator's output through the int8×int8
    products agrees with JAX's jitted one (1e-4: the same quantized
    activations, f32 reassociation elsewhere)."""
    vcfg = jconfig.VGGT_TINY
    jv = jax.jit(jvggt.init_params, static_argnums=1, static_argnames="dtype")(
        jax.random.PRNGKey(7), vcfg, dtype="float32")
    jv = jax.tree.map(lambda a: a * 4.0 if a.ndim >= 2 else a, jv)
    pv = params_from_jax(jax.tree.map(np.asarray, jv))
    jq = jvlm.quantize_vision({"vision": jv}, mode="w8a8", donate=False)["vision"]
    pq = pvlm.quantize_vision({"vision": pv}, mode="w8a8", donate=False)["vision"]
    for group in ("frame_blocks", "global_blocks"):
        for key in pvlm.VISION_BLOCK_QUANT_KEYS:
            _assert_same_tree(pq[group][key], jq[group][key])
    _assert_same_tree(pq["patch"]["blocks"]["qkv_w"], jq["patch"]["blocks"]["qkv_w"])
    images = np.random.default_rng(70).random((1, 2, 3, 56, 56)).astype(np.float32)
    (ref,), _ = jax.jit(jvggt.aggregator, static_argnums=1)(jq, vcfg, jnp.asarray(images))
    (got,), _ = pvggt.aggregator(pq, pconfig.VGGT_TINY, torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="w8 or w8a8"):
        pvlm.quantize_vision({"vision": pv}, mode="w4")


def _count_fused(monkeypatch):
    """Count the calls qwen3 makes to the fused W8 wrappers (the CPU runs
    their plain versions, so the launch counters cannot see them)."""
    calls = dict.fromkeys(FUSED, 0)
    for name in FUSED:
        real = getattr(pqwen3, name)

        def counted(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(pqwen3, name, counted)
    return calls


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_fused_w8_groups_only_for_plain_w8(mode, monkeypatch):
    """Decode steps over W8 layers call the three fused wrappers every layer;
    over W8A8 or W4 layers none of them (the JAX module's gate: a "w8" key
    and no marker)."""
    cfg = dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32")
    pcfg = port_cfg(cfg)
    pp = pqwen3.quantize_params(params_from_jax(to_np(jqwen3.init_params(jax.random.PRNGKey(8), cfg))), mode=mode)
    want = set(pqwen3.FUSED_GROUPS) if mode == "w8" else set()
    assert pqwen3._fused_groups(pp["layers"]) == want
    calls = _count_fused(monkeypatch)
    ids = torch.from_numpy(np.random.default_rng(8).integers(1, cfg.vocab_size, (3, 7)))
    gen_cfg = pengine.GenerationConfig(max_new_tokens=4, repetition_penalty=1.1, penalize_prompt=True, kv_dtype="int8")
    tokens, _ = pengine.generate_text(pp, pcfg, gen_cfg, input_ids=ids)
    assert tokens.shape == (3, 4)
    n = cfg.num_layers * 4  # 4 decode steps (the last one's logits unused)
    assert calls == dict.fromkeys(FUSED, n if mode == "w8" else 0)


@pytest.mark.parametrize("mode", ["w8a8", "w4"])
@pytest.mark.parametrize("embed", [True, False])
def test_generate_text_quantized_matches_jax(mode, embed, jax_flash_prefill):
    """``generate_text`` with W8A8 or W4 layers, penalty 1.1 over the prompt
    and generated tokens, an int8 cache and left padding: JAX's tokens and
    lengths. With ``embed`` the embedding and tied head are the int8 rows of
    every serving mode (a bf16 residual stream from the embedding on); without
    it they stay dense and the stream is f32 on both sides."""
    cfg = dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32")
    jp = jqwen3.quantize_params(jqwen3.init_params(jax.random.PRNGKey(9), cfg, dtype="float32"),
                                donate=False, mode=mode, embed=embed)
    pp = pqwen3.quantize_params(params_from_jax(to_np(jqwen3.init_params(jax.random.PRNGKey(9), cfg,
                                                                         dtype="float32"))), mode=mode, embed=embed)
    rng = np.random.default_rng(9)
    ids = rng.integers(1, cfg.vocab_size, (4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    ids[1, :3] = 0
    kw = dict(max_new_tokens=10, pad_token_id=0, eos_token_id=5, repetition_penalty=1.1, penalize_prompt=True,
              kv_dtype="int8")
    ref, ref_len = jengine.generate_text(jp, cfg, jengine.GenerationConfig(**kw), input_ids=jnp.asarray(ids),
                                         attention_mask=jnp.asarray(mask))
    got, got_len = pengine.generate_text(pp, port_cfg(cfg), pengine.GenerationConfig(**kw),
                                         input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got_len, np.asarray(ref_len))


def test_bench_w8a8_runs_on_the_cpu(monkeypatch):
    """The bench's ``--quant w8a8`` (the root bench's ``BENCH_QUANT=w8a8``):
    W8A8 layers, the tied W8 embedding, so the pure-greedy fast path (the
    fused head every step) with no fused W8 layer wrapper called."""
    from vggt_qwen3_tpu_torch import bench

    calls = _count_fused(monkeypatch)
    heads = []
    real = pqwen3.greedy_tokens
    monkeypatch.setattr(pqwen3, "greedy_tokens", lambda *a: heads.append(1) or real(*a))
    res = bench.main(["--tiny", "--device", "cpu", "--batch", "4", "--prompt", "6", "--decode", "3", "--quant", "w8a8"])
    assert res["quant"] == "w8a8" and res["tok_s"] > 0 and res["tokens"][0].shape == (4, 3)
    np.testing.assert_array_equal(*res["tokens"])
    assert heads and calls == dict.fromkeys(FUSED, 0)
