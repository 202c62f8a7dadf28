"""The port's models against the JAX package's, in float32, with the same
weights (JAX ``init_params`` → numpy → ``params_from_jax``) and the same
numpy-seeded inputs.

Where the JAX Qwen3 prefill would reach its Pallas flash kernel on the TPU,
the ``jax_flash_prefill`` fixture sends it there in interpret mode (on the
CPU backend JAX would otherwise attend over the whole cache with XLA,
int8-dequantised for an int8 cache). Left-pad query rows are compared out:
the flash kernel gives them 0 where XLA gives the mean of V, and they never
reach a valid token. Tolerance 1e-4 absolute on logits/activations of unit
scale: float32 reassociation across a few layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.models import perceiver as jperceiver
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.models import vggt as jvggt
from vggt_qwen3_tpu.models import vlm as jvlm
from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.models import perceiver as pperceiver
from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3
from vggt_qwen3_tpu_torch.models import vggt as pvggt
from vggt_qwen3_tpu_torch.models import vlm as pvlm
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

TOL = 1e-4


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(cfg):
    """The port's own dataclass with the JAX one's field values."""
    cls = getattr(pconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


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


def _qwen_setup(seed=0):
    jcfg = dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32")
    jp = jqwen3.init_params(jax.random.PRNGKey(seed), jcfg, dtype="float32")
    return jcfg, port_cfg(jcfg), jp, params_from_jax(to_np(jp))


def test_qwen3_forward_cache_free_matches():
    jcfg, pcfg, jp, pp = _qwen_setup()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.int32)
    mask[1, :3] = 0
    ref, _ = jqwen3.forward(jp, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got, cache = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_qwen3_prefill_decode_left_padded_matches(kv_dtype, jax_flash_prefill):
    jcfg, pcfg, jp, pp = _qwen_setup(1)
    rng = np.random.default_rng(1)
    B, S, N = 3, 9, 4
    ids = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[0, :4] = 0
    am[2, :1] = 0
    mask = np.zeros((B, S + N), np.int32)
    mask[:, :S] = am
    pos = np.maximum(np.cumsum(am, -1) - 1, 0).astype(np.int32)
    jc = jqwen3.init_cache(jcfg, B, S + N, dtype=kv_dtype or "float32")
    pc = pqwen3.init_cache(pcfg, B, S + N, dtype=kv_dtype or "float32", device="cpu")
    jl, jc = jqwen3.forward(jp, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                            positions=jnp.asarray(pos), cache=jc, prefill_padding="left", last_logit_only=True)
    pl, pc = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                            positions=torch.from_numpy(pos), cache=pc, prefill_padding="left", last_logit_only=True)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for t in range(N):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        mask[:, S + t] = 1
        p = (pos[:, -1:] + 1 + t).astype(np.int32)
        jl, jc = jqwen3.forward(jp, jcfg, input_ids=jnp.asarray(tok), attention_mask=jnp.asarray(mask),
                                positions=jnp.asarray(p), cache=jc, cache_offset=S + t, decode_frontier=True)
        pl, pc = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(tok), attention_mask=torch.from_numpy(mask),
                                positions=torch.from_numpy(p), cache=pc, cache_offset=S + t, decode_frontier=True)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    if kv_dtype == "int8":  # valid slots of the cache agree exactly
        k_valid = np.asarray(jc["k"])[:, 1, :, :]
        np.testing.assert_array_equal(pc["k"][:, 1].numpy(), k_valid)


def test_vggt_aggregator_matches_with_pos_embed_resize():
    cfg = dataclasses.replace(jconfig.VGGT_TINY, dtype="float32")
    jp = jvggt.init_params(jax.random.PRNGKey(2), cfg, dtype="float32")
    pp = params_from_jax(to_np(jp))
    # 70 px → a 5x5 patch grid, so the 4x4 pos embed is bicubically resized
    images = np.random.default_rng(2).uniform(0, 1, (2, 3, 3, 70, 70)).astype(np.float32)
    (ref,), psi_j = jvggt.aggregator(jp, cfg, jnp.asarray(images))
    (got,), psi_p = pvggt.aggregator(pp, port_cfg(cfg), torch.from_numpy(images))
    assert psi_j == psi_p == 5 and got.shape == ref.shape == (2, 3, 5 + 25, 2 * cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_perceiver_matches():
    cfg = jconfig.PerceiverConfig(latent_dim=32, num_latents=8, num_heads=4, num_layers=2, ffn_dim=64)
    jp = jperceiver.init_params(jax.random.PRNGKey(3), cfg, in_dim=24, out_dim=40)
    tokens = np.random.default_rng(3).standard_normal((2, 13, 24)).astype(np.float32)
    ref = jperceiver.apply(jp, cfg, jnp.asarray(tokens))
    got = pperceiver.apply(params_from_jax(to_np(jp)), port_cfg(cfg), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_splice_expand_matches():
    rng = np.random.default_rng(4)
    img = 7
    ids = np.array([[0, 0, 3, img, 4, 5], [1, img, 2, img, 3, 4], [0, 0, 0, 2, 3, 4]], np.int32)
    mask = (ids != 0).astype(np.int32)
    emb = rng.standard_normal((3, 6, 8)).astype(np.float32)
    feats = rng.standard_normal((3, 4, 8)).astype(np.float32)
    ref_e, ref_m = jvlm.splice_expand(jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(ids), jnp.asarray(feats), img)
    got_e, got_m = pvlm.splice_expand(torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(ids),
                                      torch.from_numpy(feats), img)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(ref_e))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))


def test_params_from_jax_is_bit_exact_for_bf16():
    jp = jqwen3.init_params(jax.random.PRNGKey(5), jconfig.QWEN3_TINY)  # bf16
    pp = params_from_jax(to_np(jp))
    w = np.asarray(jp["layers"]["wq"])
    assert pp["layers"]["wq"].dtype == torch.bfloat16 and tuple(pp["layers"]["wq"].shape) == w.shape
    np.testing.assert_array_equal(pp["layers"]["wq"].view(torch.int16).numpy(), w.view(np.int16))


def test_engine_matches_jax_generate(jax_flash_prefill):
    """Left-padded prompts, penalty 1.1, no-repeat-ngram 2, an EOS that some
    rows hit: fixed-length and early-exit decode agree with JAX's generate."""
    from vggt_qwen3_tpu.inference import engine as jengine
    from vggt_qwen3_tpu_torch.inference import engine as pengine

    jcfg, pcfg, jp, pp = _qwen_setup(6)
    rng = np.random.default_rng(6)
    B, S, N = 3, 7, 8
    emb = (rng.standard_normal((B, S, jcfg.hidden_size)) * 0.5).astype(np.float32)
    am = np.ones((B, S), np.int32)
    am[1, :3] = 0
    probe = pengine.GenerationConfig(max_new_tokens=N, pad_token_id=0, repetition_penalty=1.1, no_repeat_ngram=2)
    first, _ = pengine.generate(pp, pcfg, probe, inputs_embeds=torch.from_numpy(emb),
                                attention_mask=torch.from_numpy(am))
    eos = int(first[0, 2])  # row 0 finishes at step 2; others maybe never
    kw = dict(max_new_tokens=N, eos_token_id=eos, pad_token_id=0, repetition_penalty=1.1, no_repeat_ngram=2)
    jt, jl = jengine.generate(jp, jcfg, jengine.GenerationConfig(**kw), inputs_embeds=jnp.asarray(emb),
                              attention_mask=jnp.asarray(am))
    gcfg = pengine.GenerationConfig(**kw)
    pt, plen = pengine.generate(pp, pcfg, gcfg, inputs_embeds=torch.from_numpy(emb),
                                attention_mask=torch.from_numpy(am))
    et, elen, steps = pengine.generate_early_exit(pp, pcfg, gcfg, inputs_embeds=torch.from_numpy(emb),
                                                  attention_mask=torch.from_numpy(am))
    np.testing.assert_array_equal(pt, np.asarray(jt))
    np.testing.assert_array_equal(plen, np.asarray(jl))
    np.testing.assert_array_equal(et, pt)
    np.testing.assert_array_equal(elen, plen)
    assert plen[0] == 3 and 1 <= steps <= N


@pytest.mark.parametrize("call", ["chunk_at_offset", "one_token_undeclared", "two_token_decode",
                                  "per_row_block_without_query_mask"])
def test_qwen3_cached_calls_off_the_path_raise(call):
    """Cached calls off the kernels' path: a chunk at an offset (the chunked
    prefill), a one-token step that declares no frontier and a two-token
    block at one offset for all rows take plain attention over the cache,
    and their logits and written cache slots agree with JAX's fallthrough
    (1e-4); a per-row block without per-query masks still raises."""
    jcfg, pcfg, jp, pp = _qwen_setup(7)
    B, S = 2, 6
    ids_np = np.random.default_rng(7).integers(0, pcfg.vocab_size, (B, S)).astype(np.int32)
    ids = torch.from_numpy(ids_np)
    cache = pqwen3.init_cache(pcfg, B, S + 2, dtype="float32", device="cpu")
    pqwen3.forward(pp, pcfg, input_ids=ids, cache=cache, prefill_padding="left")
    jcache = jqwen3.init_cache(jcfg, B, S + 2, dtype="float32")
    _, jcache = jqwen3.forward(jp, jcfg, input_ids=jnp.asarray(ids_np), cache=jcache, prefill_padding="left")
    mask = torch.ones(B, S + 2, dtype=torch.int32)
    kw = {"chunk_at_offset": dict(input_ids=ids[:, :2], cache_offset=S),
          "one_token_undeclared": dict(input_ids=ids[:, :1], cache_offset=S),
          "two_token_decode": dict(input_ids=ids[:, :2], cache_offset=S, decode_frontier=True),
          "per_row_block_without_query_mask": dict(input_ids=ids[:, :2], cache_offset=torch.tensor([S, S - 1]),
                                                   decode_frontier=True)}[call]
    if call == "per_row_block_without_query_mask":
        with pytest.raises(ValueError, match="per-query mask"):
            pqwen3.forward(pp, pcfg, attention_mask=mask, cache=cache, **kw)
        return
    logits, cache = pqwen3.forward(pp, pcfg, attention_mask=mask, cache=cache, **kw)
    jkw = dict(kw, input_ids=jnp.asarray(kw["input_ids"].numpy()))
    jlogits, jcache = jqwen3.forward(jp, jcfg, attention_mask=jnp.asarray(mask.numpy()), cache=jcache, **jkw)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=0)
    n = kw["input_ids"].shape[1]
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, :, :, S:S + n].numpy(),
                                   np.asarray(jcache[name])[:, :, :, S:S + n], atol=TOL, rtol=0)
