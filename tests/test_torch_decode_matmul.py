"""The port's W8 decode slice against the JAX package: the quantizers, the
four fused W8 kernels' plain versions, the Qwen3 decode step, the engine's
pure-greedy fast path and the W8 QA path.

Inputs come from numpy seeds and go to both sides. Where the JAX function
reaches a Pallas kernel it runs in interpret mode, as
``tests/test_decode_matmul.py`` runs it. Tolerances:
- quantizers and the carried tree: bit-exact;
- plain versions vs Pallas in float32: rtol 2e-5, atol 2e-6 (the JAX tests'
  own: f32 reassociation); in bf16: 2e-2 relative to the output's scale by
  ``utils.agreement`` (one bf16 rounding of a projection, of the MLP's
  activation and of the output can each flip by one unit in the last place);
- the head: the same token on decisive rows (top-2 gap above 1e-5), the max
  logit at rtol 1e-6;
- the engine: at most 2 of 160 rows differ, JAX's own allowance (a W8 embed
  makes the residual stream bf16, and bf16 roundings in another order flip
  near-tied argmaxes of random weights); one decode step's logits at
  rtol/atol 5e-5 with a dense f32 embedding.

A bf16 silu: XLA's CPU backend evaluates ``jax.nn.silu`` on bf16 as
``x · 1/(1 + exp(−x))`` with each of the four steps rounded to bf16; the
Pallas MLP kernel (``decode_matmul.py:76``), its CUDA port and the port's
plain PyTorch compute silu in f32 and round once. The ``jax_silu_in_f32``
fixture gives the JAX XLA path that silu, so a comparison measures the
port, not the CPU backend's bf16 expansion (with it JAX's own kernels-vs-XLA
engine test differs in 0 rows, without it in 2).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.inference import engine as jengine
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.ops import decode_matmul as jdm
from vggt_qwen3_tpu.ops import quant as jquant
from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu_torch.inference import engine as pengine
from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3
from vggt_qwen3_tpu_torch.ops import decode_matmul as pdm
from vggt_qwen3_tpu_torch.ops import kernel_build
from vggt_qwen3_tpu_torch.ops import quant as pquant
from vggt_qwen3_tpu_torch.utils.agreement import agreement
from vggt_qwen3_tpu_torch.utils.from_jax import array_to_torch, params_from_jax

from tests.test_decode_attention import count_dispatch
from tests.test_torch_models import port_cfg, to_np

L, B, H, F = 3, 64, 256, 512  # the sizes of tests/test_decode_matmul.py
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_same_tree(got, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
        return
    assert got.dtype == array_to_torch(np.asarray(ref)).dtype, path
    np.testing.assert_array_equal(_bits(got), _jbits(ref), err_msg=path)


@pytest.fixture
def jax_flash_prefill(monkeypatch):
    """Route the JAX Qwen3 prefill through its flash kernel (interpret mode),
    the path it takes on the TPU and the port's."""
    def attend(q, k, v, *, causal=False, kv_start=None, kv_end=None):
        return jax_flash(q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, interpret=True)

    jax.clear_caches()
    monkeypatch.setattr(jqwen3, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jqwen3, "attend", attend)
    yield
    jax.clear_caches()


@pytest.fixture
def jax_silu_in_f32(monkeypatch):
    silu = jax.nn.silu
    monkeypatch.setattr(jax.nn, "silu", lambda x: silu(x.astype(jnp.float32)).astype(x.dtype))
    jax.clear_caches()
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_per_channel_bit_exact(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 96, 40)) * 0.05).astype(NP_DT[dtype])
    w[1, :, 3] = 0  # an all-zero column: the 1e-8 clamp
    ref = jax.jit(jquant.quantize_per_channel)(jnp.asarray(w))  # as quantize_params runs it
    got = pquant.quantize_per_channel(array_to_torch(w))
    _assert_same_tree(got, ref)


def test_quantize_rows_bit_exact():
    """The embedding quantizer clamps the row max before dividing by 127."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((50, 64)) * 0.02).astype(ml_dtypes.bfloat16)
    w[7] = 0
    w[9] = np.float32(1e-9)  # clamp-then-divide and divide-then-clamp differ here
    cfg = dataclasses.replace(jconfig.QWEN3_TINY, vocab_size=50)
    jp = jqwen3.init_params(jax.random.PRNGKey(0), cfg)
    jp["embed"] = jnp.asarray(w)
    ref = jqwen3.quantize_params(jp, donate=False)["embed"]
    got = pqwen3.quantize_rows(array_to_torch(w))
    _assert_same_tree(got, ref)
    per_channel_order = pquant.quantize_per_channel(array_to_torch(w).t())
    assert not torch.equal(per_channel_order["scale"][0, 9], got["scale"][9, 0])


@pytest.mark.parametrize("tied", [True, False])
def test_quantize_params_w8_bit_exact_and_carried_by_from_jax(tied):
    """quantize_params on both sides gives the same tree, and params_from_jax
    carries a JAX-quantized tree ({"w8": int8, "scale": bf16} leaves) bit for bit."""
    cfg = dataclasses.replace(jconfig.QWEN3_TINY, tie_word_embeddings=tied)
    jp = jqwen3.init_params(jax.random.PRNGKey(2), cfg)
    ref = jqwen3.quantize_params(jp, donate=False)
    carried = params_from_jax(to_np(ref))
    _assert_same_tree(carried, ref)
    pp = params_from_jax(to_np(jp))
    got = pqwen3.quantize_params(pp, donate=False)
    _assert_same_tree(got, ref)
    assert not isinstance(pp["layers"]["wq"], dict)  # donate=False leaves the input as it was
    donated = pqwen3.quantize_params(pp)
    assert donated is pp and isinstance(pp["layers"]["wq"], dict)


def test_unported_quant_modes_raise():
    pp = params_from_jax(to_np(jqwen3.init_params(jax.random.PRNGKey(3), jconfig.QWEN3_TINY)))
    for mode in ("w8a8", "w4"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pqwen3.quantize_params(pp, mode=mode, donate=False)
    w = pquant.quantize_per_channel(torch.ones(8, 4))
    x = torch.ones(2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pquant.linear(x, dict(w, a8=torch.zeros(0, dtype=torch.int8)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pquant.linear(x, {"w4p": w["w8"], "gscale": w["scale"]})


# ---------------------------------------------------------------------------
# the four plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stacked():
    """Stacked W8 weights, quantized by JAX, and the port's copies."""
    rng = np.random.default_rng(0)
    shapes = dict(gate=(L, H, F), up=(L, H, F), down=(L, F, H), wq=(L, H, 2 * H), wk=(L, H, H),
                  wv=(L, H, H), wo=(L, 2 * H, H))
    jw = {k: jax.vmap(jquant.quantize_per_channel)(jnp.asarray(rng.standard_normal(s) * 0.05, jnp.float32))
          for k, s in shapes.items()}
    return jw, params_from_jax(to_np(jw))


def _x(seed, shape, dtype):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(NP_DT[dtype])
    return jnp.asarray(a), array_to_torch(a)


def _close(got, ref, dtype):
    got = torch.as_tensor(np.asarray(got.float())) if isinstance(got, torch.Tensor) else got
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-6)
    else:
        out = agreement(got, ref)
        assert out["ok"], out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["qkv", "linear", "mlp"])
def test_layer_kernel_plain_matches_pallas(stacked, kernel, dtype):
    jw, pw = stacked
    xj, xt = _x(1, (B, 2 * H if kernel == "linear" else H), dtype)
    for li in range(L):
        if kernel == "qkv":
            ref = jdm.fused_qkv_w8(xj, jw["wq"], jw["wk"], jw["wv"], li, interpret=True)
            got = pdm.fused_qkv_w8(xt, pw["wq"], pw["wk"], pw["wv"], li)
        elif kernel == "linear":
            ref = (jdm.fused_linear_w8(xj, jw["wo"], li, interpret=True),)
            got = (pdm.fused_linear_w8(xt, pw["wo"], li),)
        else:
            ref = (jdm.fused_mlp_w8(xj, jw["gate"], jw["up"], jw["down"], li, interpret=True),)
            got = (pdm.fused_mlp_w8(xt, pw["gate"], pw["up"], pw["down"], li),)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == xt.dtype and tuple(g.shape) == r.shape
            _close(g, r, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_argmax_plain_matches_pallas(dtype):
    rng = np.random.default_rng(9)
    V, Hh = 1280, 256
    wf = rng.standard_normal((V, Hh)).astype(np.float32) * 0.05
    s = np.maximum(np.abs(wf).max(-1, keepdims=True), 1e-8) / 127.0
    w8 = np.clip(np.round(wf / s), -127, 127).astype(np.int8)
    scale = s.astype(ml_dtypes.bfloat16)
    xj, xt = _x(10, (B, Hh), dtype)
    tok_j, m_j = jdm.fused_head_argmax(xj, {"w8": jnp.asarray(w8), "scale": jnp.asarray(scale)}, interpret=True)
    head = {"w8": array_to_torch(w8), "scale": array_to_torch(scale)}
    tok_p, m_p = pdm.fused_head_argmax(xt, head)
    assert tok_p.dtype == torch.int32 and m_p.dtype == torch.float32 and tuple(tok_p.shape) == (B,)
    logits = pdm.head_logits(xt, head).numpy()
    top2 = np.sort(logits, -1)
    decisive = (top2[:, -1] - top2[:, -2]) > 1e-5
    assert decisive.sum() >= B - 2
    np.testing.assert_array_equal(tok_p.numpy()[decisive], np.asarray(tok_j)[decisive])
    np.testing.assert_allclose(m_p.numpy()[decisive], np.asarray(m_j)[decisive], rtol=1e-6)


def test_head_ties_go_to_the_lowest_index():
    head = {"w8": torch.zeros(256, 64, dtype=torch.int8), "scale": torch.ones(256, 1, dtype=torch.bfloat16)}
    head["w8"][[5, 130, 200], 3] = 7  # equal maxima in two vocab tiles of 128
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    x[:, 3] = 1
    tok, m = pdm.fused_head_argmax(x, head)
    assert tok.tolist() == [5, 5] and m.tolist() == [7.0, 7.0]


def test_wrappers_count_only_kernel_launches_and_take_the_plain_version_on_the_cpu(stacked):
    _, pw = stacked
    before = dict(pdm.launches)
    x = torch.zeros(4, H)
    pdm.fused_qkv_w8(x, pw["wq"], pw["wk"], pw["wv"], 0)
    pdm.fused_linear_w8(torch.zeros(4, 2 * H), pw["wo"], 1)
    pdm.fused_mlp_w8(x, pw["gate"], pw["up"], pw["down"], 2)
    pdm.fused_head_argmax(x, {"w8": torch.zeros(128, H, dtype=torch.int8),
                              "scale": torch.ones(128, 1, dtype=torch.bfloat16)})
    assert pdm.launches == before
    meta = torch.zeros(4, H, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pdm.fused_linear_w8(meta, pw["wq"], 0)
    with pytest.raises(ValueError, match="unsupported device"):
        pdm.fused_head_argmax(meta, {"w8": torch.zeros(128, H, dtype=torch.int8),
                                     "scale": torch.ones(128, 1, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------------
# the decoder and the engine at the JAX engine tests' dims
# ---------------------------------------------------------------------------


def _engine_cfg():
    """``tests/test_decode_matmul.py::_engine_cfg``: every JAX kernel's gate
    passes at B=160 with a 16-token prompt and 16 new tokens."""
    return jconfig.Qwen3Config(
        vocab_size=256, hidden_size=512, num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
        intermediate_size=256, rope_theta=1e4, tie_word_embeddings=True, dtype="float32",
    )


@pytest.fixture
def jax_kernels_forced(monkeypatch, jax_flash_prefill, jax_silu_in_f32):
    for flag in ("VGGT_DECODE_KERNEL", "VGGT_DECODE_MATMUL", "VGGT_HEAD_KERNEL"):
        monkeypatch.setenv(flag, "force")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_engine_w8_greedy_fast_path_matches_jax(jax_kernels_forced, monkeypatch):
    cfg = _engine_cfg()
    jp = jqwen3.quantize_params(jqwen3.init_params(jax.random.PRNGKey(3), cfg, dtype="float32"), donate=False)
    pp = params_from_jax(to_np(jp))
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 256, (160, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[:3, :5] = 0
    mask[:3, :5] = 0
    kw = dict(max_new_tokens=16, pad_token_id=0, eos_token_id=7, kv_dtype="int8")
    calls = count_dispatch(monkeypatch, jdm, "fused_head_argmax")
    ref, ref_len = jengine.generate_text(jp, cfg, jengine.GenerationConfig(**kw), input_ids=jnp.asarray(ids),
                                         attention_mask=jnp.asarray(mask))
    assert calls["n"] > 0, "the JAX side did not take its fused head"
    gcfg = pengine.GenerationConfig(**kw)
    assert pengine.greedy_fast_path(pp, pcfg, gcfg)
    emb = pqwen3.embed_tokens(pp, torch.from_numpy(ids))
    got, got_len = pengine.generate(pp, pcfg, gcfg, inputs_embeds=emb, attention_mask=torch.from_numpy(mask))
    ref, ref_len = np.asarray(ref), np.asarray(ref_len)
    differ = (got != ref).any(axis=1)
    assert int(differ.sum()) <= 2, f"{int(differ.sum())}/160 rows differ"
    np.testing.assert_array_equal(got_len[~differ], ref_len[~differ])
    assert (ref == 7).any(), "no row reached EOS: the done/pad semantics went untested"


def test_decode_step_logits_match_jax_with_forced_kernels(jax_kernels_forced, monkeypatch):
    """Prefill and one W8 decode step (the three layer kernels' plain
    versions) against JAX with its Pallas kernels, at the logits. A dense f32
    embedding keeps the residual stream f32, as in the JAX test, and so does
    an f32 cache: with an int8 cache, f32 noise in k/v flips a few values by
    one int8 step (~1e-3 on these logits); the engine test covers int8."""
    cfg = _engine_cfg()
    jp = jqwen3.quantize_params(jqwen3.init_params(jax.random.PRNGKey(2), cfg, dtype="float32"),
                                donate=False, embed=False)
    pp, pcfg = params_from_jax(to_np(jp)), port_cfg(cfg)
    counts = [count_dispatch(monkeypatch, jdm, n) for n in ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8")]
    rng = np.random.default_rng(7)
    Bn, S, total = 160, 16, 32
    ids = rng.integers(1, 256, (Bn, S)).astype(np.int32)
    mask = np.zeros((Bn, total), np.int32)
    mask[:, :S] = 1
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (Bn, S))
    jc = jqwen3.init_cache(cfg, Bn, total, dtype="float32")
    pc = pqwen3.init_cache(pcfg, Bn, total, dtype="float32")
    jl0, jc = jqwen3.forward(jp, cfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                             positions=jnp.asarray(pos), cache=jc, prefill_padding="left", last_logit_only=True)
    pl0, pc = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                             positions=torch.from_numpy(pos.copy()), cache=pc, prefill_padding="left",
                             last_logit_only=True)
    np.testing.assert_allclose(pl0.numpy(), np.asarray(jl0), rtol=5e-5, atol=5e-5)
    tok = np.asarray(jnp.argmax(jl0[:, -1], -1)).astype(np.int32)[:, None]
    mask[:, S] = 1
    step = np.full((Bn, 1), S, np.int32)
    jl1, _ = jqwen3.forward(jp, cfg, input_ids=jnp.asarray(tok), attention_mask=jnp.asarray(mask),
                            positions=jnp.asarray(step), cache=jc, cache_offset=S, decode_frontier=True)
    pl1, _ = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(tok), attention_mask=torch.from_numpy(mask),
                            positions=torch.from_numpy(step), cache=pc, cache_offset=S, decode_frontier=True)
    np.testing.assert_allclose(pl1.numpy(), np.asarray(jl1), rtol=5e-5, atol=5e-5)
    assert all(c["n"] > 0 for c in counts), "the JAX step did not reach its W8 kernels"


def test_decode_step_routes_w8_layers_through_the_fused_wrappers(monkeypatch):
    """A W8 decode step calls the three layer wrappers once a layer, on the
    stacked weights; the prefill does not."""
    cfg = port_cfg(dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32"))
    pp = pqwen3.quantize_params(pqwen3.init_params(torch.Generator().manual_seed(0), cfg))
    seen = []
    for name in ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8"):
        real = getattr(pqwen3, name)

        def spy(x, *w, _name=name, _real=real):
            seen.append((_name, w[-1], w[0] is pp["layers"][{"fused_qkv_w8": "wq", "fused_linear_w8": "wo",
                                                              "fused_mlp_w8": "gate"}[_name]]))
            return _real(x, *w)

        monkeypatch.setattr(pqwen3, name, spy)
    Bn, S = 2, 5
    cache = pqwen3.init_cache(cfg, Bn, S + 1, dtype="int8")
    mask = torch.ones(Bn, S + 1, dtype=torch.int32)
    ids = torch.randint(1, cfg.vocab_size, (Bn, S))
    tok, cache = pqwen3.forward_greedy(pp, cfg, input_ids=ids, attention_mask=mask, cache=cache,
                                       prefill_padding="left")
    assert not seen
    pqwen3.forward_greedy(pp, cfg, input_ids=tok[:, None], attention_mask=mask, cache=cache, cache_offset=S,
                          positions=torch.full((Bn, 1), S), decode_frontier=True)
    assert seen == [(n, li, True) for li in range(cfg.num_layers)
                    for n in ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8")]


FUSED_WRAPPERS = ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8")


@pytest.mark.parametrize("targets,fused", [
    (("q_proj", "k_proj", "v_proj", "o_proj"), {"fused_mlp_w8"}),  # the shipped qkvo LoRA
    (("v_proj", "down_proj"), {"fused_linear_w8"}),
    (tuple(pqwen3.LORA_TARGET_MAP), set()),
], ids=["qkvo", "v_down", "all"])
def test_w8_decode_step_with_lora_fuses_each_group_without_adapters_as_jax(jax_kernels_forced, monkeypatch,
                                                                           targets, fused):
    """With LoRA adapters on a W8 tree, a decode step runs the fused kernel of
    each projection group (QKV, WO, MLP) that has no adapter, as the JAX
    module gates each group on its own adapters; the logits agree with JAX's
    (nonzero B, so the adapters count) at the forced-kernels test's
    tolerance."""
    cfg = _engine_cfg()
    lora_cfg = jconfig.LoRAConfig(enable=True, rank=4, alpha=8, target_modules=targets)
    jp = jqwen3.add_lora(jqwen3.init_params(jax.random.PRNGKey(4), cfg, dtype="float32"), cfg, lora_cfg,
                         jax.random.PRNGKey(5))  # a trained tree, then quantized for serving
    jp = to_np(jqwen3.quantize_params(jp, donate=False, embed=False))
    rng = np.random.default_rng(9)
    for ad in jp["layers"]["lora"].values():
        ad["B"] = (rng.standard_normal(ad["B"].shape) * 0.02).astype(np.float32)
    pp, pcfg = params_from_jax(jp), port_cfg(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    jcounts = {n: count_dispatch(monkeypatch, jdm, n) for n in FUSED_WRAPPERS}
    seen = set()
    for name in FUSED_WRAPPERS:
        real = getattr(pqwen3, name)
        monkeypatch.setattr(pqwen3, name, lambda *a, _n=name, _r=real: seen.add(_n) or _r(*a))
    Bn, S, total = 64, 4, 64  # the JAX decode gates need B·T ≥ 4096
    ids = rng.integers(1, 256, (Bn, S)).astype(np.int32)
    mask = np.zeros((Bn, total), np.int32)
    mask[:, :S] = 1
    jc = jqwen3.init_cache(cfg, Bn, total, dtype="float32")
    pc = pqwen3.init_cache(pcfg, Bn, total, dtype="float32")
    _, jc = jqwen3.forward(jp, cfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask), cache=jc,
                           prefill_padding="left", last_logit_only=True)
    _, pc = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                           cache=pc, prefill_padding="left", last_logit_only=True)
    assert not seen
    tok = ids[:, -1:]
    mask[:, S] = 1
    step = np.full((Bn, 1), S, np.int32)
    jl, _ = jqwen3.forward(jp, cfg, input_ids=jnp.asarray(tok), attention_mask=jnp.asarray(mask),
                           positions=jnp.asarray(step), cache=jc, cache_offset=S, decode_frontier=True)
    pl, _ = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(tok), attention_mask=torch.from_numpy(mask),
                           positions=torch.from_numpy(step), cache=pc, cache_offset=S, decode_frontier=True)
    assert seen == fused
    assert {n for n, c in jcounts.items() if c["n"]} == fused
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=5e-5, atol=5e-5)


# ---------------------------------------------------------------------------
# the W8 QA path and the bench
# ---------------------------------------------------------------------------


def _jax_w8_qa_reference() -> None:
    """The JAX side of the W8 QA comparison, run in its own process (see
    the test): prints the generated tokens, lengths and records as JSON."""
    import json
    import sys

    from vggt_qwen3_tpu.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu.inference import qa as jqa

    from tests.test_torch_qa_slice import MAX_NEW, setup as qa_setup

    jqwen3.flash_eligible = lambda *a: True
    jqwen3.attend = lambda q, k, v, *, causal=False, kv_start=None, kv_end=None: jax_flash(
        q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, interpret=True)
    silu = jax.nn.silu
    jax.nn.silu = lambda x: silu(x.astype(jnp.float32)).astype(x.dtype)
    jstage, _, jparams, _, samples = qa_setup.__wrapped__()
    seen = []
    real = jqa.generate_batch

    def capture(*a, **k):
        tokens, lengths = real(*a, **k)
        seen.append((np.asarray(tokens).tolist(), np.asarray(lengths).tolist()))
        return tokens, lengths

    jqa.generate_batch = capture
    res = jqa.run_inference(jparams, jstage, load_tokenizer(None), samples, max_new_tokens=MAX_NEW,
                            batch_size=8, kv_dtype="int8", verbose=False, quantize=True)
    json.dump({"batches": seen, "records": res}, sys.stdout)


def test_qa_run_inference_quantized_matches_jax(monkeypatch):
    """``run_inference(quantize=True)`` on the tiny QA slice of
    ``tests/test_torch_qa_slice.py`` with the int8 cache (the W8 serving
    configuration): penalty 1.1, so the decode steps run the three layer
    kernels' plain versions (M = 8 rows) and the int8 LM head. Generated
    tokens and predictions equal JAX's.

    W8 turns this float32 model's residual stream into bf16. Compiled XLA on
    the CPU may skip bf16 roundings inside a fusion (its default excess
    precision): after one layer 68 % of the hidden values differ from the
    same program run op by op, which the port's eager PyTorch matches. So
    the JAX side runs in a process of its own with
    ``--xla_allow_excess_precision=false``, and with the flash prefill and
    the f32 silu as in the tests above."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer as pload_tokenizer
    from vggt_qwen3_tpu_torch.inference import qa as pqa

    from tests.test_torch_qa_slice import MAX_NEW, _capture, setup as qa_setup

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run(
        [sys.executable, "-c", "from tests.test_torch_decode_matmul import _jax_w8_qa_reference as f; f()"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout)

    _, pstage, _, pparams, samples = qa_setup.__wrapped__()
    p_tok = _capture(monkeypatch, pqa)
    rows = []
    real_qkv = pqwen3.fused_qkv_w8
    monkeypatch.setattr(pqwen3, "fused_qkv_w8", lambda x, *a: rows.append(x.shape[0]) or real_qkv(x, *a))
    pres = pqa.run_inference(pparams, pstage, pload_tokenizer(None), samples, max_new_tokens=MAX_NEW,
                             batch_size=8, kv_dtype="int8", verbose=False, quantize=True, device="cpu")
    assert not isinstance(pparams["text"]["layers"]["wq"], dict)  # the caller's tree is left as it was
    assert rows and set(rows) == {8}
    assert len(ref["batches"]) == len(p_tok) == 1
    np.testing.assert_array_equal(p_tok[0][0], np.asarray(ref["batches"][0][0]))
    np.testing.assert_array_equal(p_tok[0][1], np.asarray(ref["batches"][0][1]))
    assert pres == ref["records"]


@pytest.mark.parametrize("quant,kv", [("w8", "int8"), ("none", "bf16")])
def test_bench_runs_on_the_cpu(monkeypatch, capsys, quant, kv):
    """W8 takes the pure-greedy fast path (the fused head every step); bf16
    weights take the logits path."""
    from vggt_qwen3_tpu_torch import bench

    calls = []
    real = pqwen3.greedy_tokens
    monkeypatch.setattr(pqwen3, "greedy_tokens", lambda *a: calls.append(1) or real(*a))
    res = bench.main(["--tiny", "--device", "cpu", "--batch", "4", "--prompt", "6", "--decode", "3",
                      "--quant", quant, "--kv", kv])
    assert res["tok_s"] > 0 and len(res["walls_s"]) == 2 and res["kind"] == "cpu"
    assert all(t.shape == (4, 3) for t in res["tokens"])
    np.testing.assert_array_equal(res["tokens"][0], res["tokens"][1])
    # warm-up, prefill-only and two timed runs: (1 + 3) + 1 + 2·(1 + 3) head calls
    assert len(calls) == (4 + 1 + 8 if quant == "w8" else 0)
    assert '"tok_s"' in capsys.readouterr().out.splitlines()[-1]


def test_bench_defaults_to_the_card_and_raises_without_it(monkeypatch):
    from vggt_qwen3_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = bench.parse_args([])
    assert (args.batch, args.prompt, args.decode, args.quant, args.kv, args.device) == \
        (368, 32, 128, "w8", "int8", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.setup(args)


# ---------------------------------------------------------------------------
# w8_gemm's host side, its launches stubbed (the kernel runs on the card only)
# ---------------------------------------------------------------------------

def _stub_gemm_launches(monkeypatch):
    """``w8_gemm`` replaced by a recorder of its arguments (pointers as ints)
    that returns 0; CPU tensors take the kernel's path."""
    calls = []

    class Lib:
        @staticmethod
        def w8_gemm(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(pdm, "_lib", lambda: Lib)
    monkeypatch.setattr(pdm, "_use_kernel", lambda name, x: True)
    monkeypatch.setattr(pdm, "_stream", lambda x: 0)
    return calls


def _qwen3_like_w8(L_, K, ns):
    return [{"w8": torch.zeros(L_, K, n, dtype=torch.int8), "scale": torch.ones(L_, 1, n, dtype=torch.bfloat16)}
            for n in ns]


@pytest.mark.parametrize("M", [1, 8, 28, 368])
def test_qkv_and_lone_launches_pass_the_same_rows_and_depth(monkeypatch, M):
    """One QKV launch and a launch over each of its weights alone get the
    same (M, K), so the same plan and summation order; each segment is
    layer li of its stack by pointer offset (first and last layer), with its
    own N and its own [M, N] output."""
    calls = _stub_gemm_launches(monkeypatch)
    K, ns, L_ = 2560, (4096, 1024, 1024), 3
    ws = _qwen3_like_w8(L_, K, ns)
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    for li in (0, L_ - 1):
        calls.clear()
        q, k, v = pdm.fused_qkv_w8(x, *ws, li)
        lone = [pdm.fused_linear_w8(x, w, li) for w in ws]
        assert len(calls) == 4 and {c[1:3] for c in calls} == {(M, K)}
        assert calls[0][-2] == 3 and all(c[-2] == 1 for c in calls[1:])
        for j, (w, out) in enumerate(zip(ws, (q, k, v))):
            seg = calls[0][3 + 4 * j: 7 + 4 * j]
            assert seg == (w["w8"].data_ptr() + li * K * ns[j], w["scale"].data_ptr() + 2 * li * ns[j],
                           out.data_ptr(), ns[j])
            assert calls[1 + j][3:7] == (seg[0], seg[1], lone[j].data_ptr(), ns[j])
            assert out.shape == lone[j].shape == (M, ns[j])


def test_gemm_wrappers_raise_before_a_launch(monkeypatch):
    """The shapes w8_gemm does not take raise in the wrapper, naming the
    rule, and launch nothing; Qwen3-4B's widths (2560, 4096, 1024, 9728)
    pass."""
    calls = _stub_gemm_launches(monkeypatch)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="K a multiple of 64"):
        pdm.fused_linear_w8(torch.zeros(4, 96, dtype=bf), *_qwen3_like_w8(1, 96, (128,)), 0)
    with pytest.raises(ValueError, match="N a multiple of 128"):
        pdm.fused_linear_w8(torch.zeros(4, 128, dtype=bf), *_qwen3_like_w8(1, 128, (192,)), 0)
    with pytest.raises(ValueError, match="N a multiple of 128"):
        pdm.fused_qkv_w8(torch.zeros(4, 128, dtype=bf), *_qwen3_like_w8(1, 128, (256, 128, 64)), 0)
    with pytest.raises(ValueError, match="contiguous bf16"):
        pdm.fused_linear_w8(torch.zeros(4, 128), *_qwen3_like_w8(1, 128, (128,)), 0)
    with pytest.raises(ValueError, match="layer 1 outside"):
        pdm.fused_linear_w8(torch.zeros(4, 128, dtype=bf), *_qwen3_like_w8(1, 128, (128,)), 1)
    assert calls == []
    for K, n in ((2560, 4096), (2560, 1024), (4096, 2560), (9728, 2560)):
        pdm.fused_linear_w8(torch.zeros(2, K, dtype=bf), *_qwen3_like_w8(1, K, (n,)), 0)
    assert [c[1:3] + (c[6],) for c in calls] == [(2, 2560, 4096), (2, 2560, 1024), (2, 4096, 2560),
                                                  (2, 9728, 2560)]


@pytest.mark.parametrize("variant", sorted(chip_smoke.TILES["decode_matmul"][0]))
def test_w8_gemm_tile_variants_name_defines_the_source_reads(variant):
    """The w8_gemm sweep (``chip_smoke.py --tiles decode_matmul``) builds
    each variant with nvcc defines; ``kernel_build.rebuild`` refuses a define
    the source does not read under ``#ifndef``, so a renamed define cannot
    time the shipped build under another name."""
    defines = chip_smoke.TILES["decode_matmul"][0][variant]
    src = (kernel_build.CSRC / "decode_matmul.cu").read_text()
    assert defines and all(f"#ifndef {k}\n" in src for k in defines)
    with pytest.raises(ValueError, match="reads no define"):
        kernel_build.rebuild("decode_matmul", {**defines, "NO_SUCH_SIZE": 1})
