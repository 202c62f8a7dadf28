"""The port's flash-attention backward against the JAX package's Pallas one.

On the CPU ``flash_attention`` goes through the port's ``autograd.Function``
whose backward is ``flash_attention_backward_plain`` (the numerics the CUDA
kernels 8 and 9 are held to on the card); the JAX side is ``jax.vjp`` of its
``flash_attention`` in interpret mode with 8-row blocks, so its dq and dk/dv
Pallas kernels run as on the TPU (as ``tests/test_flash_attention.py`` runs
them). Inputs and cotangents come from a numpy seed and go to both sides.

Tolerances: float32 atol 3e-5, rtol 1e-4 (the JAX package's own for its
backward); bf16 inputs under ``utils.agreement`` (tol 2e-2 scaled to the
reference, ‖err‖₂ ≤ 5e-3·‖ref‖₂). Query rows with no valid key get exactly 0
on both sides, whatever their cotangent.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu.ops.flash_attention import flash_attention as jax_flash
from vggt_qwen3_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse
import chip_smoke
from vggt_qwen3_tpu_torch.ops import flash_attention as pflash
from vggt_qwen3_tpu_torch.ops import kernel_build
from vggt_qwen3_tpu_torch.utils.agreement import agreement
from vggt_qwen3_tpu_torch.utils.from_jax import array_to_torch

NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}

CASES = {
    "noncausal": dict(B=2, S=13, T=21, NH=4, NKV=4, D=16, causal=False, starts=None, ends=None),
    "causal_left_pads": dict(B=3, S=17, T=17, NH=4, NKV=4, D=8, causal=True, starts=[0, 3, 9], ends=[17, 15, 17]),
    "gqa_group4": dict(B=2, S=19, T=19, NH=8, NKV=2, D=16, causal=True, starts=[2, 0], ends=[19, 19]),
    "dead_row": dict(B=2, S=8, T=8, NH=2, NKV=2, D=8, causal=False, starts=None, ends=[8, 0]),
}


def _inputs(c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(c["B"], c["S"], c["NH"], c["D"]), (c["B"], c["T"], c["NKV"], c["D"]),
              (c["B"], c["T"], c["NKV"], c["D"]), (c["B"], c["S"], c["NH"], c["D"])]
    arrs = [rng.standard_normal(s).astype(NP_DT[dtype]) for s in shapes]
    kw_j, kw_t = {}, {}
    for key, name in (("starts", "kv_start"), ("ends", "kv_end")):
        if c[key] is not None:
            a = np.asarray(c[key], np.int32)
            kw_j[name], kw_t[name] = jnp.asarray(a), torch.from_numpy(a)
    return arrs, kw_j, kw_t


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _jax_grads(arrs, kw, causal, with_lse=False, g_lse=None):
    q, k, v, g = (jnp.asarray(a) for a in arrs)
    if with_lse:
        fn = lambda q, k, v: jax_flash_lse(q, k, v, causal=causal, block_q=8, block_kv=8, interpret=True, **kw)  # noqa: E731
        (out, lse), vjp = jax.vjp(fn, q, k, v)
        return out, lse, vjp((g, jnp.asarray(g_lse)))
    fn = lambda q, k, v: jax_flash(q, k, v, causal=causal, block_q=8, block_kv=8, interpret=True, **kw)  # noqa: E731
    out, vjp = jax.vjp(fn, q, k, v)
    return out, None, vjp(g)


def _port_grads(arrs, kw, causal, with_lse=False, g_lse=None):
    q, k, v, g = (array_to_torch(a).requires_grad_(i < 3) for i, a in enumerate(arrs))
    if with_lse:
        out, lse = pflash.flash_attention_with_lse(q, k, v, causal=causal, **kw)
        torch.autograd.backward((out, lse), (g, torch.from_numpy(g_lse)))
    else:
        out, lse = pflash.flash_attention(q, k, v, causal=causal, **kw), None
        out.backward(g)
    assert out.grad_fn is not None
    return out.detach(), lse, (q.grad, k.grad, v.grad)


def _dead(c):
    """[B, S] query rows that see no key."""
    S, T = c["S"], c["T"]
    starts = np.asarray(c["starts"] if c["starts"] is not None else [0] * c["B"])
    ends = np.asarray(c["ends"] if c["ends"] is not None else [T] * c["B"])
    q = np.arange(S)[None, :]
    hi = np.minimum(ends[:, None], q + 1) if c["causal"] else np.broadcast_to(ends[:, None], (c["B"], S))
    return hi <= starts[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_pallas(case, dtype):
    c = CASES[case]
    arrs, kw_j, kw_t = _inputs(c, dtype)
    _, _, ref = _jax_grads(arrs, kw_j, c["causal"])
    _, _, got = _port_grads(arrs, kw_t, c["causal"])
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == array_to_torch(arrs[0]).dtype and a.shape == r.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(_f32(a), _f32(r), atol=3e-5, rtol=1e-4, err_msg=name)
        else:
            res = agreement(torch.from_numpy(_f32(a)), torch.from_numpy(_f32(r)))
            assert res["ok"], (name, res)
    dead = _dead(c)
    if dead.any():
        assert not _f32(got[0])[dead].any() and not _f32(ref[0])[dead].any()
    if case == "dead_row":  # batch row 1 sees no key at all: zero gradients throughout
        assert not any(_f32(t)[1].any() for t in got)


@pytest.mark.parametrize("case", ["causal_left_pads", "gqa_group4"])
def test_with_lse_and_lse_cotangent_match_pallas(case):
    """flash_attention_with_lse: the lse equals JAX's (−1e30 on dead rows)
    and a nonzero lse cotangent folds into the backward as in JAX."""
    c = CASES[case]
    arrs, kw_j, kw_t = _inputs(c, "float32", seed=1)
    g_lse = np.random.default_rng(2).standard_normal((c["B"], c["NH"], c["S"])).astype(np.float32)
    out_j, lse_j, ref = _jax_grads(arrs, kw_j, c["causal"], with_lse=True, g_lse=g_lse)
    out_t, lse_t, got = _port_grads(arrs, kw_t, c["causal"], with_lse=True, g_lse=g_lse)
    lse_j, lse_t = np.asarray(lse_j), lse_t.detach().numpy()
    assert lse_t.shape == lse_j.shape == (c["B"], c["NH"], c["S"]) and lse_t.dtype == np.float32
    live = lse_j > -1e29
    np.testing.assert_allclose(lse_t[live], lse_j[live], atol=3e-5, rtol=1e-5)
    assert (lse_t[~live] == -1e30).all() and (~live).any()
    live_rows = ~_dead(c)  # the Pallas forward leaves a mean of V on dead rows; the port writes 0
    np.testing.assert_allclose(_f32(out_t)[live_rows], _f32(out_j)[live_rows], atol=1e-5, rtol=1e-5)
    assert not _f32(out_t)[~live_rows].any()
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(_f32(a), _f32(r), atol=3e-5, rtol=1e-4, err_msg=name)


def test_plain_backward_gradcheck_float64():
    """The plain forward and backward are each other's derivative (float64,
    causal with left pads and GQA, both outputs)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 9, 4, 8, dtype=torch.float64, generator=g, requires_grad=True)
    k = torch.randn(2, 9, 2, 8, dtype=torch.float64, generator=g, requires_grad=True)
    v = torch.randn(2, 9, 2, 8, dtype=torch.float64, generator=g, requires_grad=True)
    start, end = torch.tensor([0, 3]), torch.tensor([9, 7])
    assert torch.autograd.gradcheck(
        lambda q, k, v: pflash.flash_attention_with_lse(q, k, v, causal=True, kv_start=start, kv_end=end),
        (q, k, v))


def test_bounds_get_no_gradient_and_the_backward_counts_no_launch():
    q = torch.randn(1, 6, 2, 8, requires_grad=True)
    before = (pflash.launches, pflash.dq_launches, pflash.dkv_launches)
    out = pflash.flash_attention(q, q.detach(), q.detach(), kv_start=torch.tensor([1]), kv_end=torch.tensor([5]))
    out.sum().backward()
    assert q.grad is not None and (pflash.launches, pflash.dq_launches, pflash.dkv_launches) == before


def test_card_path_goes_through_the_autograd_function(monkeypatch):
    """With the kernel launches stubbed (a kernel returns fresh tensors with
    no autograd history, as the CUDA wrappers do), an input that requires
    grad still gets its gradient through FlashAttention, from the backward
    kernels' wrapper. A wrapper that returned the forward kernel's output as
    it is would leave ``out.grad_fn`` None: no gradient through attention."""
    calls = []

    def fake_fwd(q, k, v, start, end, causal, scale, with_lse):
        calls.append("fwd")
        with torch.no_grad():
            out, lse = pflash.flash_attention_plain_with_lse(q, k, v, causal=causal, kv_start=start,
                                                             kv_end=end, scale=scale)
        return out, (lse if with_lse else None)

    def fake_bwd(q, k, v, start, end, lse, delta, d_out, causal, scale):
        calls.append("bwd")
        out, _ = pflash.flash_attention_plain_with_lse(q, k, v, causal=causal, kv_start=start, kv_end=end,
                                                       scale=scale)
        return pflash.flash_attention_backward_plain(q, k, v, start, end, out, lse, d_out, causal=causal,
                                                     scale=scale)

    monkeypatch.setattr(pflash, "_on_card", lambda x: True)
    monkeypatch.setattr(pflash, "_check_kernel_shapes", lambda q, k, v: None)
    monkeypatch.setattr(pflash, "flash_fwd_kernel", fake_fwd)
    monkeypatch.setattr(pflash, "flash_bwd_kernels", fake_bwd)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 10, 2, 16, generator=g, requires_grad=True) for _ in range(3))
    out = pflash.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None, "no gradient would flow through the attention kernel"
    d_out = torch.randn(out.shape, generator=g)
    out.backward(d_out)
    assert calls == ["fwd", "bwd"]
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o, lse = pflash.flash_attention_plain_with_lse(*ref, causal=True)
    want = pflash.flash_attention_backward_plain(*[t.detach() for t in ref], None, None, o.detach(),
                                                 lse.detach(), d_out, causal=True)
    for a, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(a, w)
    with torch.no_grad():  # inference: the kernel alone, no lse written
        calls.clear()
        assert pflash.flash_attention(q, k, v).grad_fn is None and calls == ["fwd"]


def _stub_backward_launches(monkeypatch):
    """The backward kernels' launches replaced by a recorder (their library
    functions get every argument, pointers as ints, and return 0), and the
    padded lse/delta buffers the wrapper makes kept for inspection."""
    calls, made = {}, []

    def lib(name):
        def fn(*args):
            calls[name] = args
            return 0
        return fn

    buffer = pflash._stat_buffer

    def recording(*args):
        made.append(buffer(*args))
        return made[-1]

    monkeypatch.setattr(pflash, "_bwd_lib", lib)
    monkeypatch.setattr(pflash, "_stream", lambda x: 0)
    monkeypatch.setattr(pflash, "_stat_buffer", recording)
    return calls, made


@pytest.mark.parametrize("S", [1, 128, 1029])
def test_backward_kernels_get_lse_and_delta_padded_to_whole_tiles(monkeypatch, S):
    """lse and delta reach both kernels in [B, NH, S_pad] buffers (S_pad the
    next multiple of 128, so every tile's rows are a 16-byte aligned bulk
    copy) with the same values up to S, −1e30 (a dead row) and 0 past it:
    delta, rowsum(dO·out) − g_lse, written straight into its buffer."""
    calls, made = _stub_backward_launches(monkeypatch)
    monkeypatch.setattr(pflash, "_on_card", lambda x: True)
    g = torch.Generator().manual_seed(4)
    B, NH, NKV, D = 2, 4, 2, 64
    q, d_out, out = (torch.randn(B, S, NH, D, generator=g).bfloat16() for _ in range(3))
    k, v = (torch.randn(B, S, NKV, D, generator=g).bfloat16() for _ in range(2))
    lse, g_lse = torch.randn(B, NH, S, generator=g), torch.randn(B, NH, S, generator=g)
    lse[1, 2] = pflash.NEG_INF
    n0 = (pflash.dq_launches, pflash.dkv_launches)
    dq, dk, dv = pflash.flash_attention_backward(q, k, v, None, None, out, lse, d_out, g_lse)
    assert (pflash.dq_launches, pflash.dkv_launches) == (n0[0] + 1, n0[1] + 1)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    delta_p, lse_p = made
    S_pad = -(-S // 128) * 128
    assert lse_p.shape == delta_p.shape == (B, NH, S_pad) and lse_p.dtype == delta_p.dtype == torch.float32
    assert lse_p.is_contiguous() and delta_p.is_contiguous()
    delta = (d_out.float() * out.float()).sum(-1).transpose(1, 2) - g_lse
    assert torch.equal(lse_p[..., :S], lse) and torch.equal(delta_p[..., :S], delta)
    assert (lse_p[..., S:] == -1e30).all() and not delta_p[..., S:].any()
    for name in ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"):
        args = calls[name]
        assert args[4:6] == (lse_p.data_ptr(), delta_p.data_ptr()), name
        n_out = 1 if name == "flash_bwd_dq_bf16" else 2
        assert args[8 + n_out:8 + n_out + 7] == (B, S, S, NH, NKV, D, S_pad), name


def test_backward_kernels_refuse_an_unpadded_delta(monkeypatch):
    """delta must come as its padded [B, NH, S_pad] buffer: the kernels read
    whole tiles of it."""
    calls, _ = _stub_backward_launches(monkeypatch)
    B, S, NH, D = 2, 8, 2, 64
    x = torch.zeros(B, S, NH, D, dtype=torch.bfloat16)
    bounds = torch.zeros(B, dtype=torch.int32), torch.full((B,), S, dtype=torch.int32)
    with pytest.raises(ValueError, match="delta must be a contiguous f32"):
        pflash.flash_bwd_kernels(x, x, x, *bounds, torch.zeros(B, NH, S), torch.zeros(B, NH, S), x, False, 0.125)
    assert not calls


def test_backward_kernels_refuse_views_tma_cannot_address(monkeypatch):
    """q, k, v or d_out that a TMA tensor map cannot address is refused, with
    a message that says why, before anything is launched: a broadcast (stride
    0) dimension, a base that is not 16-byte aligned, a row stride that is
    not a multiple of 16 bytes."""
    calls, _ = _stub_backward_launches(monkeypatch)
    B, S, NH, D = 2, 8, 2, 64
    ok = torch.zeros(B, S, NH, D, dtype=torch.bfloat16)
    stats = torch.zeros(B, NH, S), torch.zeros(B, NH, S)
    bounds = torch.zeros(B, dtype=torch.int32), torch.full((B,), S, dtype=torch.int32)
    wide = torch.zeros(B, S, NH, D + 8, dtype=torch.bfloat16)
    bad = {
        "a TMA tensor map cannot address": torch.zeros(1, S, NH, D, dtype=torch.bfloat16).expand(B, S, NH, D),
        "16-byte aligned base": wide[..., 4:4 + D],
        "multiples of 8 elements": torch.zeros(B, S, NH, D + 4, dtype=torch.bfloat16)[..., :D],
    }
    for why, x in bad.items():
        for pos in range(4):
            ops = [ok, ok, ok, ok]
            ops[pos] = x
            with pytest.raises(ValueError, match=why):
                pflash.flash_bwd_kernels(*ops[:3], *bounds, *stats, ops[3], False, 0.125)
    assert not calls


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 8, 2, 64)])
def test_backward_copies_a_cotangent_tma_cannot_address(monkeypatch, shape):
    """Autograd may hand the backward a broadcast cotangent (the gradient of
    a sum; one broadcast over the batch has a contiguous head dim): the
    wrapper copies it before the kernels read it."""
    seen = []
    monkeypatch.setattr(pflash, "_on_card", lambda x: True)
    monkeypatch.setattr(pflash, "flash_bwd_kernels", lambda *a: seen.append(a[7]) or (None, None, None))
    B, S, NH, D = 2, 8, 2, 64
    x = torch.zeros(B, S, NH, D, dtype=torch.bfloat16)
    d_out = torch.ones(shape, dtype=torch.bfloat16).expand(B, S, NH, D)
    pflash.flash_attention_backward(x, x, x, None, None, x, torch.zeros(B, NH, S), d_out)
    assert seen[0].is_contiguous() and torch.equal(seen[0], d_out)


@pytest.mark.parametrize("pos", [0, 1, 2])
def test_backward_copies_a_broadcast_input_the_forward_takes(monkeypatch, pos):
    """The forward's kernel reads a broadcast (stride 0) q, k or v through its
    strides; a TMA map cannot address one, so the backward copies it rather
    than refusing what the forward took."""
    seen = []
    monkeypatch.setattr(pflash, "_on_card", lambda x: True)
    monkeypatch.setattr(pflash, "flash_bwd_kernels", lambda *a: seen.append(a) or (None, None, None))
    B, S, NH, D = 2, 8, 2, 64
    x = torch.zeros(B, S, NH, D, dtype=torch.bfloat16)
    ops = [x, x, x]
    ops[pos] = torch.randn(1, S, NH, D).bfloat16().expand(B, S, NH, D)
    pflash.flash_attention_backward(*ops, None, None, x, torch.zeros(B, NH, S), x)
    got = seen[0][pos]
    assert got.is_contiguous() and torch.equal(got, ops[pos])
    assert all(seen[0][i] is x for i in range(3) if i != pos)


@pytest.mark.parametrize("variant", sorted(chip_smoke.FLASH_BWD_TILES))
def test_flash_bwd_tile_variants_name_defines_the_source_reads(variant):
    """The tile sweep (``chip_smoke.py --tiles flash_bwd``) builds each variant
    with nvcc defines; ``kernel_build.rebuild`` refuses a define the source
    does not read under ``#ifndef``, so a renamed size cannot time the
    shipped build under another name."""
    src = (kernel_build.CSRC / "flash_bwd.cu").read_text()
    assert all(f"#ifndef {k}\n" in src for k in chip_smoke.FLASH_BWD_TILES[variant])
    with pytest.raises(ValueError, match="reads no define"):
        kernel_build.rebuild("flash_bwd", {**chip_smoke.FLASH_BWD_TILES[variant], "NO_SUCH_SIZE": 1})


def test_forward_kernel_refuses_views_tma_cannot_address(monkeypatch):
    """The forward kernel's wrapper takes q, k and v through TMA tensor maps
    as the backward's does: a view a map cannot address is refused, with a
    message that says why, before anything is built or launched."""
    monkeypatch.setattr(pflash, "_fwd_lib", lambda: pytest.fail("the forward was launched"))
    B, S, NH, D = 2, 8, 2, 64
    ok = torch.zeros(B, S, NH, D, dtype=torch.bfloat16)
    bounds = torch.zeros(B, dtype=torch.int32), torch.full((B,), S, dtype=torch.int32)
    wide = torch.zeros(B, S, NH, D + 8, dtype=torch.bfloat16)
    bad = {
        "a TMA tensor map cannot address": torch.zeros(1, S, NH, D, dtype=torch.bfloat16).expand(B, S, NH, D),
        "16-byte aligned base": wide[..., 4:4 + D],
        "multiples of 8 elements": torch.zeros(B, S, NH, D + 4, dtype=torch.bfloat16)[..., :D],
    }
    for why, x in bad.items():
        for pos in range(3):
            ops = [ok, ok, ok]
            ops[pos] = x
            with pytest.raises(ValueError, match=why):
                pflash.flash_fwd_kernel(*ops, *bounds, False, 0.125, True)


@pytest.mark.parametrize("pos", [0, 1, 2])
def test_forward_copies_a_broadcast_input(monkeypatch, pos):
    """A broadcast (stride 0) q, k or v reaches the forward kernel as a
    contiguous copy, counted in ``fwd_copies``; the other operands and the
    strided views the VGGT blocks hand over (``qkv.chunk``) go as they are."""
    seen = []
    monkeypatch.setattr(pflash, "_on_card", lambda x: True)
    monkeypatch.setattr(pflash, "flash_fwd_kernel", lambda *a: seen.append(a) or (None, None))
    monkeypatch.setattr(pflash, "fwd_copies", dict.fromkeys("qkv", 0))
    B, S, NH, D = 2, 8, 2, 64
    qkv = torch.zeros(B, S, 3 * NH * D, dtype=torch.bfloat16)
    ops = [t.reshape(B, S, NH, D) for t in qkv.chunk(3, dim=-1)]
    bcast = torch.randn(1, S, NH, D).bfloat16().expand(B, S, NH, D)
    pflash.flash_attention(*ops)
    assert all(a is b for a, b in zip(seen[0][:3], ops)) and pflash.fwd_copies == dict.fromkeys("qkv", 0)
    ops[pos] = bcast
    pflash.flash_attention(*ops)
    got = seen[1][pos]
    assert got.is_contiguous() and torch.equal(got, bcast)
    assert all(seen[1][i] is ops[i] for i in range(3) if i != pos)
    assert pflash.fwd_copies == {n: int(i == pos) for i, n in enumerate("qkv")}


@pytest.mark.parametrize("variant", sorted(chip_smoke.FLASH_FWD_TILES))
def test_flash_fwd_tile_variants_name_defines_the_source_reads(variant):
    """The forward's sweep (``chip_smoke.py --tiles flash_fwd``) builds each
    variant with nvcc defines the source reads under ``#ifndef``;
    ``kernel_build.rebuild`` refuses any other."""
    src = (kernel_build.CSRC / "flash_fwd.cu").read_text()
    assert all(f"#ifndef {k}\n" in src for k in chip_smoke.FLASH_FWD_TILES[variant])
    with pytest.raises(ValueError, match="reads no define"):
        kernel_build.rebuild("flash_fwd", {**chip_smoke.FLASH_FWD_TILES[variant], "NO_SUCH_SIZE": 1})


def test_build_target_hashes_the_headers_a_source_includes(monkeypatch, tmp_path):
    """A library's path hashes its source, the ``csrc/`` headers it includes
    (``#include "..."``, through other headers too) and the flags: an edit to
    the shared Hopper header gives the three sources that include it (both
    flash sources and the W8 GEMMs) a new build, while an edit to a header
    they do not include, or to another source, gives none, and a source that
    includes no header keeps its build."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in kernel_build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernel_build, "CSRC", csrc)
    names = ("flash_fwd", "flash_bwd", "decode_matmul")
    before = {n: kernel_build._target(n) for n in names}
    for n in names:
        assert {p.name for p in kernel_build._sources(csrc / f"{n}.cu")} == {f"{n}.cu", "hopper.cuh"}
    (csrc / "other.cuh").write_text("// not included\n")
    (csrc / "decode_attention.cu").write_text("// another source\n")
    assert {n: kernel_build._target(n) for n in names} == before
    alone = kernel_build._target("decode_attention")
    (csrc / "deeper.cuh").write_text("#define DEEPER 1\n")
    with (csrc / "hopper.cuh").open("a") as f:
        f.write('#include "deeper.cuh"\n')
    after = {n: kernel_build._target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert kernel_build._target("decode_attention") == alone
    (csrc / "deeper.cuh").write_text("#define DEEPER 2\n")
    assert kernel_build._target("flash_fwd") != after["flash_fwd"]
    assert kernel_build._target("flash_fwd", {"FWD_STAGES_64": 2}) != kernel_build._target("flash_fwd")
