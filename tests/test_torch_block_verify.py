"""Kernel 3 (speculative block-verify attention) and the per-row cached
forward of the port against the JAX package.

On the CPU the port's wrapper runs its plain version (the kernel's
numerics). It is held to JAX's Pallas ``gqa_block_verify_attention`` in
interpret mode and to JAX's XLA ``mha`` / ``mha_quantized_kv`` under the
[B, S, T] per-query mask (the path JAX takes on the CPU), with ragged
starts and offsets, a layer other than 0, and large garbage values in the
slots past every row's frontier (which only the mask hides). A query with no
valid slot is exactly 0 in the port; JAX's Pallas kernel gives such a row
the mean of V, so those rows are compared out. Tolerances: float32 1e-5
(reassociation only); bf16 2e-2 (one bf16 rounding of the output, and of P
on JAX's XLA path).

The CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_gpu.py``.
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
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.ops.attention import mha as jax_mha
from vggt_qwen3_tpu.ops.attention import mha_quantized_kv as jax_mha_q
from vggt_qwen3_tpu.ops.decode_attention import gqa_block_verify_attention as jax_verify
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3
from vggt_qwen3_tpu_torch.ops import decode_attention as pdecode
from vggt_qwen3_tpu_torch.ops import kernel_build
from vggt_qwen3_tpu_torch.utils.from_jax import array_to_torch, params_from_jax

L, B, NH, NKV, T, D = 3, 4, 8, 2, 48, 64
LI = 1
GARBAGE = 1e4  # past the frontiers: a kernel that reads them is far off
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _bounds(S):
    """Ragged starts and offsets: row 1 has a left pad, row 2's query 0 sees
    no slot (start > off), row 3's offset is past T − S, where the end clamp
    acts."""
    start = np.array([0, 5, 30, 2], np.int32)
    off = np.array([20, 33, 28, T - 2], np.int32)
    return start, off


def _inputs(rng, S, cache: str):
    """q [B, S, NH, D]; the stacked cache with GARBAGE past every row's last
    visible slot (and before its start)."""
    dt = "bfloat16" if cache in ("bfloat16", "int8") else "float32"
    start, off = _bounds(S)
    q = rng.standard_normal((B, S, NH, D)).astype(NP_DT[dt])
    hidden = np.zeros((B, T), bool)
    for b in range(B):
        end_last = min(off[b] + 1, T - (S - 1)) + S - 1
        hidden[b, end_last:] = True
        hidden[b, :start[b]] = True
    hidden = np.repeat(hidden[:, None, :], NKV, axis=1)  # [B, NKV, T]
    if cache == "int8":
        k = rng.integers(-127, 128, (L, B, NKV, T, D)).astype(np.int8)
        v = rng.integers(-127, 128, (L, B, NKV, T, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (L, B, NKV, T)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (L, B, NKV, T)).astype(np.float32)
        k[:, hidden] = 127
        v[:, hidden] = 127
        ks[:, hidden] = GARBAGE
        vs[:, hidden] = GARBAGE
        return q, k, v, ks.astype(ml_dtypes.bfloat16), vs.astype(ml_dtypes.bfloat16), start, off
    k = rng.standard_normal((L, B, NKV, T, D))
    v = rng.standard_normal((L, B, NKV, T, D))
    k[:, hidden] = GARBAGE
    v[:, hidden] = GARBAGE
    return q, k.astype(NP_DT[dt]), v.astype(NP_DT[dt]), None, None, start, off


def _port(q, k, v, ks, vs, start, off):
    t = lambda a: None if a is None else array_to_torch(a)  # noqa: E731
    return pdecode.gqa_block_verify_attention(t(q), t(k), t(v), LI, torch.from_numpy(start),
                                              torch.from_numpy(off), t(ks), t(vs))


def _query_mask(S, start, off):
    """[B, S, T]: query j sees [start, end0 + j), the JAX wrapper's clamp."""
    end0 = np.clip(off + 1, 0, T - (S - 1))
    pos = np.arange(T)
    return (pos[None, None, :] >= start[:, None, None]) & (
        pos[None, None, :] < (end0[:, None] + np.arange(S)[None, :])[:, :, None])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("S", [1, 4, 7])
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_block_verify_plain_matches_pallas(S, cache):
    rng = np.random.default_rng(10 + S)
    q, k, v, ks, vs, start, off = _inputs(rng, S, cache)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = _f32(jax_verify(j(q), j(k), j(v), LI, j(start), j(off), j(ks), j(vs), interpret=True, block_b=2))
    got = _port(q, k, v, ks, vs, start, off)
    assert got.shape == (B, S, NH, D) and got.dtype == torch.bfloat16
    live = _query_mask(S, start, off).any(-1)  # [B, S]
    assert not live.all() and live.any()
    np.testing.assert_allclose(_f32(got)[live], ref[live], atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    assert not got[torch.from_numpy(~live)].any(), "a query with no valid slot must give exactly 0"


@pytest.mark.parametrize("S", [1, 4, 7])
@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_block_verify_plain_matches_xla_mha_under_the_query_mask(S, cache):
    rng = np.random.default_rng(20 + S)
    q, k, v, ks, vs, start, off = _inputs(rng, S, cache)
    q = q.astype(np.float32)  # the float32 model's queries
    mask = jnp.asarray(_query_mask(S, start, off))[:, None]  # [B, 1, S, T]
    if cache == "int8":
        ref = jax_mha_q(jnp.asarray(q), jnp.asarray(k[LI]), jnp.asarray(ks[LI]), jnp.asarray(v[LI]),
                        jnp.asarray(vs[LI]), mask=mask, kv_heads_major=True)
    else:
        ref = jax_mha(jnp.asarray(q), jnp.asarray(k[LI]), jnp.asarray(v[LI]), mask=mask, kv_heads_major=True)
    got = _port(q, k, v, ks, vs, start, off)
    assert got.dtype == torch.float32
    live = _query_mask(S, start, off).any(-1)
    np.testing.assert_allclose(_f32(got)[live], _f32(ref)[live], atol=TOL["float32"], rtol=1e-4)


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_block_verify_with_one_query_is_the_decode_attention(cache):
    rng = np.random.default_rng(30)
    q, k, v, ks, vs, start, off = _inputs(rng, 1, cache)
    t = lambda a: None if a is None else array_to_torch(a)  # noqa: E731
    got = _port(q, k, v, ks, vs, start, off)[:, 0]
    ref = pdecode.gqa_decode_attention_plain(t(q)[:, 0], t(k), t(v), LI, torch.from_numpy(start),
                                             torch.from_numpy(np.minimum(off + 1, T)), t(ks), t(vs))
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=1e-6, rtol=1e-6)


def test_block_verify_wrapper_counts_only_kernel_launches_and_dispatches_by_device():
    before = (pdecode.launches, pdecode.verify_launches)
    q = torch.zeros(1, 3, 2, 64)
    cache = torch.zeros(1, 1, 2, 8, 64)
    pdecode.gqa_block_verify_attention(q, cache, cache, 0, torch.tensor([0]), torch.tensor([2]))
    assert (pdecode.launches, pdecode.verify_launches) == before
    meta = torch.zeros(1, 1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pdecode.gqa_block_verify_attention(q.to("meta"), meta, meta, 0, torch.tensor([0]), torch.tensor([2]))


# ---------------------------------------------------------------------------
# the per-row cached forward (qwen3.forward with [B] offsets)
# ---------------------------------------------------------------------------


def _qwen_tiny(seed):
    jcfg = dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32")
    jp = jqwen3.init_params(jax.random.PRNGKey(seed), jcfg, dtype="float32")
    jp = jax.tree.map(lambda a: a * 4 if a.ndim >= 2 else a, jp)  # so attention moves the logits
    pcfg = pconfig.Qwen3Config(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    return jcfg, pcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _random_cache(rng, cfg, Bc, Tc, kv_dtype):
    shape = (cfg.num_layers, Bc, cfg.num_kv_heads, Tc, cfg.head_dim)
    if kv_dtype == "int8":
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(0.005, 0.02, shape[:-1]).astype(ml_dtypes.bfloat16),
                "vs": rng.uniform(0.005, 0.02, shape[:-1]).astype(ml_dtypes.bfloat16)}
    return {"k": rng.standard_normal(shape).astype(np.float32), "v": rng.standard_normal(shape).astype(np.float32)}


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_qwen3_per_row_forward_matches_jax(S, kv_dtype):
    """A cache at ragged per-row depths (left pads, garbage past each row's
    frontier): logits and the whole cache after the per-row writes."""
    jcfg, pcfg, jp, pp = _qwen_tiny(40)
    rng = np.random.default_rng(40 + S)
    Bc, Tc = 3, 32
    cache = _random_cache(rng, jcfg, Bc, Tc, kv_dtype)
    off = np.array([12, 20, 9], np.int32)
    start = np.array([0, 3, 6], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, (Bc, S)).astype(np.int32)
    pos = (off - start)[:, None] + np.arange(S)[None, :]
    tpos = np.arange(Tc)
    qmask = ((tpos[None, None, :] >= start[:, None, None])
             & (tpos[None, None, :] <= (off[:, None] + np.arange(S)[None, :])[:, :, None])).astype(np.int32)
    mask = qmask[:, 0] if S == 1 else qmask  # one token: the [B, T] frontier mask
    jl, jc = jqwen3.forward(jp, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                            positions=jnp.asarray(pos), cache={n: jnp.asarray(a) for n, a in cache.items()},
                            cache_offset=jnp.asarray(off), decode_frontier=True)
    pc = {n: array_to_torch(a) for n, a in cache.items()}
    pl, pc2 = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                             positions=torch.from_numpy(pos), cache=pc, cache_offset=torch.from_numpy(off),
                             decode_frontier=True)
    assert pc2 is pc  # written in place
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for n in cache:
        want = np.asarray(jc[n]).astype(np.float32)
        if kv_dtype == "int8":  # the quantised K/V and their scales agree exactly
            np.testing.assert_array_equal(_f32(pc[n]), want)
        else:  # layer 2's K/V carry layer 1's attention: float32 reassociation
            np.testing.assert_allclose(_f32(pc[n]), want, atol=1e-4, rtol=1e-4)


def test_qwen3_per_row_write_past_the_cache_end_stays_in_its_row():
    """A finished row's verify block may run past the last slot; its writes
    stay in its own row, positions past the end are dropped as the JAX
    scatter drops them (slot T−1 holds the block's position 1, not a later
    one), and the cache equals JAX's (tolerance as above): row 0 in every
    layer, row 1 in layer 0. Row 1's later layers carry its attention, which
    JAX's CPU path takes under the raw mask and the kernels (JAX's and the
    port's) under the ``end0`` clamp to T − (S − 1)."""
    jcfg, pcfg, jp, pp = _qwen_tiny(41)
    rng = np.random.default_rng(41)
    Bc, Tc, S = 2, 16, 4
    cache = _random_cache(rng, pcfg, Bc, Tc, "float32")
    pc = {n: array_to_torch(a) for n, a in cache.items()}
    before = {n: t.clone() for n, t in pc.items()}
    off = np.array([5, 14], np.int32)  # row 1 writes slots 14..17 of 16
    mask = (np.arange(Tc)[None, None, :] <= (off[:, None] + np.arange(S))[:, :, None]).astype(np.int32)
    ids = rng.integers(0, pcfg.vocab_size, (Bc, S)).astype(np.int32)
    logits, _ = pqwen3.forward(pp, pcfg, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                               cache=pc, cache_offset=torch.from_numpy(off), decode_frontier=True)
    _, jc = jqwen3.forward(jp, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                           cache={n: jnp.asarray(a) for n, a in cache.items()}, cache_offset=jnp.asarray(off),
                           decode_frontier=True)
    assert torch.isfinite(logits).all()
    assert torch.equal(pc["k"][:, 0, :, 9:], before["k"][:, 0, :, 9:])
    assert torch.equal(pc["k"][:, 1, :, :14], before["k"][:, 1, :, :14])
    assert not torch.equal(pc["k"][:, 1, :, 15], before["k"][:, 1, :, 15])
    for n in cache:
        got, want = _f32(pc[n]), np.asarray(jc[n])
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got[0, 1], want[0, 1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(chip_smoke.TILES["decode_attention"][0]))
def test_attention_tile_variants_name_defines_the_source_reads(variant):
    """The sweep of kernels 2 and 3 (``chip_smoke.py --tiles
    decode_attention``) builds each variant with nvcc defines;
    ``kernel_build.rebuild`` refuses a define the source does not read under
    ``#ifndef``, so a renamed define cannot time the shipped build under
    another name."""
    defines = chip_smoke.TILES["decode_attention"][0][variant]
    src = (kernel_build.CSRC / "decode_attention.cu").read_text()
    assert defines and all(f"#ifndef {k}\n" in src for k in defines)
    with pytest.raises(ValueError, match="reads no define"):
        kernel_build.rebuild("decode_attention", {**defines, "NO_SUCH_SIZE": 1})
