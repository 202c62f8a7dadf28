"""Each CUDA kernel of the port against its plain PyTorch version on the card.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up for the CPU
suite.) Whether a card is present is decided inside each test body, so every
pytest worker collects the same tests; without a card they skip.
Tolerance: ``utils.agreement`` with tol 2e-2, scaled to the reference (every
element within 2e-2·max|ref| + 2e-2·|ref|, ‖err‖₂ ≤ 5e-3·‖ref‖₂), and for
decode attention and block verify in the split tests ‖err‖₂ ≤ 2e-4·‖ref‖₂
(they keep P in f32 as a bf16 head and residual; P rounded to bf16 once
read 2.1e-3 on an H100); rows with
no valid key exactly 0; the block-verify kernel's inputs hold 1e4 in every
slot no query sees, so a kernel that reads past a frontier fails. The W8 head: the same token on rows whose top-2 gap
exceeds 1e-4·max|logit| (f32 sums in another order move a logit by far
less), at least 99 % of the rows at M = 368; the max logit at rtol 1e-5.
"""

import ctypes

import pytest
import torch

from vggt_qwen3_tpu_torch.ops import decode_attention as pdecode
from vggt_qwen3_tpu_torch.ops import decode_matmul as pdm
from vggt_qwen3_tpu_torch.ops import flash_attention as pflash
from vggt_qwen3_tpu_torch.utils.agreement import agreement


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with `pytest -m gpu --noconftest` on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("D,NH,NKV,causal", [(64, 16, 16, False), (128, 32, 8, True), (64, 4, 2, True)])
def test_flash_kernel_matches_plain(D, NH, NKV, causal):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S = 3, 150
    q = torch.randn(B, S, NH, D, device="cuda", generator=g).bfloat16()
    k = torch.randn(B, S, NKV, D, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, S, NKV, D, device="cuda", generator=g).bfloat16()
    start = torch.tensor([0, 17, 70], dtype=torch.int32, device="cuda")
    end = torch.tensor([150, 150, 130], dtype=torch.int32, device="cuda")
    n0 = pflash.launches
    got = pflash.flash_attention(q, k, v, causal=causal, kv_start=start, kv_end=end)
    torch.cuda.synchronize()
    assert pflash.launches == n0 + 1
    ref = pflash.flash_attention_plain(q, k, v, causal=causal, kv_start=start, kv_end=end)
    assert agreement(got, ref)["ok"], agreement(got, ref)
    if causal:
        assert not got[1, :17].any() and not got[2, :70].any()


@pytest.mark.gpu
def test_flash_kernel_reads_strided_views():
    """q/k/v as the VGGT block hands them over: views into one packed qkv."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    B, T, NH, D = 2, 77, 4, 64
    qkv = torch.randn(B, T, 3 * NH * D, device="cuda", generator=g).bfloat16()
    q, k, v = (t.reshape(B, T, NH, D) for t in qkv.chunk(3, dim=-1))
    assert not v.is_contiguous()
    got = pflash.flash_attention(q, k, v)
    ref = pflash.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    assert agreement(got, ref)["ok"], agreement(got, ref)


def _backward_inputs(g, D, NH, NKV, causal, B=3, S=150):
    """Ragged bounds (row 1 left-padded: with ``causal`` its first 17 queries
    see no key; row 2 ends at 130), 1e4 in every K/V slot outside the
    frontier, a random output cotangent."""
    q = torch.randn(B, S, NH, D, device="cuda", generator=g).bfloat16()
    k = torch.randn(B, S, NKV, D, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, S, NKV, D, device="cuda", generator=g).bfloat16()
    start = torch.tensor([0, 17, 70][:B], dtype=torch.int32, device="cuda")
    end = torch.tensor([150, 150, 130][:B], dtype=torch.int32, device="cuda")
    pos = torch.arange(S, device="cuda")
    outside = ((pos[None] < start[:, None]) | (pos[None] >= end[:, None]))[:, :, None, None]
    k.masked_fill_(outside, 1e4)
    v.masked_fill_(outside, 1e4)
    d_out = torch.randn(B, S, NH, D, device="cuda", generator=g).bfloat16()
    return q, k, v, start, end, d_out, outside


@pytest.mark.gpu
@pytest.mark.parametrize("D,NH,NKV,causal", [(64, 16, 16, False), (128, 32, 8, True), (64, 4, 2, True)])
def test_flash_lse_matches_plain(D, NH, NKV, causal):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, start, end, _, _ = _backward_inputs(g, D, NH, NKV, causal)
    out, lse = pflash.flash_attention_with_lse(q, k, v, causal=causal, kv_start=start, kv_end=end)
    ref_out, ref_lse = pflash.flash_attention_plain_with_lse(q, k, v, causal=causal, kv_start=start, kv_end=end)
    assert lse.shape == (3, NH, 150) and lse.dtype == torch.float32
    live = ref_lse > -1e29
    torch.testing.assert_close(lse[live], ref_lse[live], rtol=0, atol=1e-4)
    assert (lse[~live] == -1e30).all() and (not causal or (~live).any())
    assert agreement(out, ref_out)["ok"]


@pytest.mark.gpu
@pytest.mark.parametrize("D,NH,NKV,causal", [(64, 16, 16, False), (128, 32, 8, True), (64, 4, 2, True)])
def test_flash_backward_kernels_match_plain(D, NH, NKV, causal):
    """Kernels 8 and 9 against the plain backward on the same lse and output;
    dead rows and keys no query sees get exactly 0."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, start, end, d_out, outside = _backward_inputs(g, D, NH, NKV, causal)
    out, lse = pflash.flash_attention_with_lse(q, k, v, causal=causal, kv_start=start, kv_end=end)
    g_lse = torch.randn(lse.shape, device="cuda", generator=g) * 0.1
    n0 = (pflash.dq_launches, pflash.dkv_launches)
    got = pflash.flash_attention_backward(q, k, v, start, end, out, lse, d_out, g_lse, causal=causal)
    torch.cuda.synchronize()
    assert (pflash.dq_launches, pflash.dkv_launches) == (n0[0] + 1, n0[1] + 1)
    ref = pflash.flash_attention_backward_plain(q, k, v, start, end, out, lse, d_out, g_lse, causal=causal)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape and a.dtype == torch.bfloat16, name
        assert agreement(a, r)["ok"], (name, agreement(a, r))
    dq, dk, dv = got
    assert not dk[outside.expand_as(dk)].any() and not dv[outside.expand_as(dv)].any()
    if causal:
        assert not dq[1, :17].any(), "a query with no valid key must get exactly 0"


@pytest.mark.gpu
def test_flash_autograd_runs_the_backward_kernels_on_strided_views():
    """q/k/v as the VGGT block hands them over (views into one packed qkv
    that requires grad): the gradient comes from kernels 8 and 9."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(13)
    B, T, NH, D = 2, 77, 4, 64
    qkv = torch.randn(B, T, 3 * NH * D, device="cuda", generator=g).bfloat16().requires_grad_()
    d_out = torch.randn(B, T, NH, D, device="cuda", generator=g).bfloat16()
    q, k, v = (t.reshape(B, T, NH, D) for t in qkv.chunk(3, dim=-1))
    n0 = (pflash.launches, pflash.dq_launches, pflash.dkv_launches)
    out = pflash.flash_attention(q, k, v)
    assert out.grad_fn is not None
    (out.float() * d_out.float()).sum().backward()
    torch.cuda.synchronize()
    assert (pflash.launches, pflash.dq_launches, pflash.dkv_launches) == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    qc, kc, vc = (t.detach().contiguous() for t in (q, k, v))
    o, lse = pflash.flash_attention_plain_with_lse(qc, kc, vc)
    ref = torch.cat([t.reshape(B, T, NH * D) for t in
                     pflash.flash_attention_backward_plain(qc, kc, vc, None, None, o, lse, d_out)], dim=-1)
    assert agreement(qkv.grad, ref)["ok"], agreement(qkv.grad, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("D,NH,NKV", [(128, 32, 8), (64, 4, 2)])
def test_decode_kernel_matches_plain(quant, D, NH, NKV):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    L, B, T = 3, 4, 90
    q = torch.randn(B, NH, D, device="cuda", generator=g).bfloat16()
    if quant:
        k = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=g, dtype=torch.int8)
        ks = (torch.rand(L, B, NKV, T, device="cuda", generator=g) * 0.02).bfloat16()
        vs = (torch.rand(L, B, NKV, T, device="cuda", generator=g) * 0.02).bfloat16()
    else:
        k = torch.randn(L, B, NKV, T, D, device="cuda", generator=g).bfloat16()
        v = torch.randn(L, B, NKV, T, D, device="cuda", generator=g).bfloat16()
        ks = vs = None
    start = torch.tensor([0, 3, 40, 89], dtype=torch.int32, device="cuda")
    end = torch.tensor([90, 50, 41, 90], dtype=torch.int32, device="cuda")
    args = (q, k, v, 2, start, end, ks, vs)
    n0 = pdecode.launches
    got = pdecode.gqa_decode_attention(*args)
    torch.cuda.synchronize()
    assert pdecode.launches == n0 + 1
    ref = pdecode.gqa_decode_attention_plain(*args)
    assert agreement(got, ref)["ok"], agreement(got, ref)


def _verify_inputs(g, S, D, NH, NKV, quant, L=3, B=4, T=96):
    """Ragged starts and offsets (row 2's query 0 sees no slot; row 3's
    offset is past T − S, where the end clamp acts) and garbage in every
    slot no query sees."""
    q = torch.randn(B, S, NH, D, device="cuda", generator=g).bfloat16()
    start = torch.tensor([0, 7, 60, 3], dtype=torch.int32, device="cuda")
    off = torch.tensor([50, 80, 58, T - 2], dtype=torch.int32, device="cuda")
    end0 = (off.long() + 1).clamp(0, T - (S - 1))
    pos = torch.arange(T, device="cuda")
    hidden = ((pos[None] < start[:, None]) | (pos[None] >= (end0 + S - 1)[:, None]))[None, :, None, :]
    if quant:
        k = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=g, dtype=torch.int8)
        ks = (torch.rand(L, B, NKV, T, device="cuda", generator=g) * 0.02).bfloat16()
        vs = (torch.rand(L, B, NKV, T, device="cuda", generator=g) * 0.02).bfloat16()
        ks.masked_fill_(hidden, 1e4)
        vs.masked_fill_(hidden, 1e4)
    else:
        k = torch.randn(L, B, NKV, T, D, device="cuda", generator=g).bfloat16()
        v = torch.randn(L, B, NKV, T, D, device="cuda", generator=g).bfloat16()
        k.masked_fill_(hidden[..., None], 1e4)
        v.masked_fill_(hidden[..., None], 1e4)
        ks = vs = None
    return q, k, v, start, off, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 4, 7, 32])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("D,NH,NKV", [(128, 32, 8), (64, 4, 2)])
def test_block_verify_kernel_matches_plain(S, quant, D, NH, NKV):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, start, off, ks, vs = _verify_inputs(g, S, D, NH, NKV, quant)
    args = (q, k, v, 2, start, off, ks, vs)
    n0, d0 = pdecode.verify_launches, pdecode.launches
    got = pdecode.gqa_block_verify_attention(*args)
    torch.cuda.synchronize()
    assert (pdecode.verify_launches, pdecode.launches) == (n0 + 1, d0)
    ref = pdecode.gqa_block_verify_attention_plain(*args)
    assert got.shape == ref.shape == q.shape and got.dtype == torch.bfloat16
    assert agreement(got, ref)["ok"], agreement(got, ref)
    end0 = (off.long() + 1).clamp(0, k.shape[3] - (S - 1))
    empty = (start.long()[:, None] >= end0[:, None] + torch.arange(S, device="cuda")[None, :])  # [B, S]
    assert empty[2, 0] and not got[empty].any(), "a query with no valid slot must give exactly 0"


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_block_verify_kernel_with_one_query_matches_the_decode_kernel(quant):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, start, off, ks, vs = _verify_inputs(g, 1, 128, 32, 8, quant)
    got = pdecode.gqa_block_verify_attention(q, k, v, 1, start, off, ks, vs)[:, 0]
    ref = pdecode.gqa_decode_attention(q[:, 0].contiguous(), k, v, 1, start, (off + 1).clamp_max(k.shape[3]), ks, vs)
    assert agreement(got, ref)["ok"], agreement(got, ref)


@pytest.mark.gpu
def test_block_verify_wrapper_raises_on_shapes_the_kernel_does_not_take():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(10)
    q, k, v, start, off, _, _ = _verify_inputs(g, 4, 128, 32, 8, False)
    with pytest.raises(ValueError):  # S * group = 132 score rows
        pdecode.gqa_block_verify_attention(q.repeat(1, 9, 1, 1)[:, :33].contiguous(), k, v, 0, start, off)
    with pytest.raises(ValueError):  # f32 queries
        pdecode.gqa_block_verify_attention(q.float(), k, v, 0, start, off)
    with pytest.raises(ValueError):  # D = 32
        x = torch.zeros(4, 2, 8, 32, device="cuda", dtype=torch.bfloat16)
        c = torch.zeros(1, 4, 2, 16, 32, device="cuda", dtype=torch.bfloat16)
        pdecode.gqa_block_verify_attention(x, c, c, 0, start, off)
    with pytest.raises(ValueError):  # no such layer
        pdecode.gqa_block_verify_attention(q, k, v, 3, start, off)
    with pytest.raises(ValueError):  # not contiguous
        pdecode.gqa_block_verify_attention(q.transpose(1, 2), k, v, 0, start, off)


ATTENTION_REL_RMS = 2e-4  # ‖err‖₂ / ‖ref‖₂ of kernels 2 and 3, as chip_smoke.py holds them


def _attention_inputs(g, S, T, starts, lasts, quant, *, NH=32, NKV=8, D=128, L=2):
    """Rows whose queries see [start, last - (S - 1) + j) (decode: S = 1,
    kv_end = last; verify: kv_off = last - S), and 1e4 in every slot no
    query of a row sees. Returns the arguments of both wrappers at layer 1
    (kv_end or kv_off as the fifth) and the [B, S] queries with no slot."""
    B = len(starts)
    q = torch.randn(B, S, NH, D, device="cuda", generator=g).bfloat16()
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    last = torch.tensor(lasts, dtype=torch.int32, device="cuda")
    pos = torch.arange(T, device="cuda")
    s0 = start.long().clamp(0, T)
    hidden = ((pos[None] < s0[:, None]) | (pos[None] >= last.long().clamp(0, T)[:, None]))[None, :, None, :]
    if quant:
        k = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=g, dtype=torch.int8)
        ks = (torch.rand(L, B, NKV, T, device="cuda", generator=g) * 0.02).bfloat16().masked_fill_(hidden, 1e4)
        vs = (torch.rand(L, B, NKV, T, device="cuda", generator=g) * 0.02).bfloat16().masked_fill_(hidden, 1e4)
    else:
        k = torch.randn(L, B, NKV, T, D, device="cuda", generator=g).bfloat16().masked_fill_(hidden[..., None], 1e4)
        v = torch.randn(L, B, NKV, T, D, device="cuda", generator=g).bfloat16().masked_fill_(hidden[..., None], 1e4)
        ks = vs = None
    ends = last - S if S > 1 else last  # kv_off for verify, kv_end for decode
    q_end = (ends.long() + (1 if S > 1 else 0)).clamp(0, T - (S - 1))[:, None] + torch.arange(S, device="cuda")
    empty = s0[:, None] >= q_end
    return (q if S > 1 else q[:, 0].contiguous(), k, v, 1, start, ends, ks, vs), empty


def _attend(args, S):
    """The kernel (decode for S = 1, verify else) and its plain version."""
    if S == 1:
        return pdecode.gqa_decode_attention(*args), pdecode.gqa_decode_attention_plain(*args)
    return pdecode.gqa_block_verify_attention(*args), pdecode.gqa_block_verify_attention_plain(*args)


def _held(got, ref, empty, S):
    torch.cuda.synchronize()
    if S == 1:
        got, ref = got[:, None], ref[:, None]
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert not got[empty].any(), "a query with no valid slot must give exactly 0"
    agree = agreement(got[~empty], ref[~empty])
    assert agree["ok"] and agree["rel_rms"] <= ATTENTION_REL_RMS, agree


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("S", [1, 7, 32])
def test_attention_splits_at_their_edges(S, quant):
    """T = 215 (not a multiple of the tile) in 4 splits. The kernel cuts a
    row's slots [start, last) into shares of ceil(ceil(n / 4) / 16) · 16
    slots counted back from ``last``; the rows below hit these edges."""
    _need_card()
    T = 215
    plan = pdecode.attention_plan(8, S, 32, 8, T, 128, quant)
    assert plan["splits"] == 4, plan
    starts, lasts = zip(
        (0, 215),    # the whole cache: shares of 64, the first one cut to 23 at start
        (3, 131),    # n = 128: every split exactly full, [3, 35) [35, 67) [67, 99) [99, 131)
        (10, 139),   # n = 129: shares of 48, the first split empty
        (50, 60),    # n = 10: only the last split has slots
        (215, 215),  # start = T: every split empty, every query exactly 0
        (-5, 300),   # bounds clamped to [0, T)
        (0, 65),     # n = 65: shares of 32, one slot in the second split, [0, 1)
        (0, 64),     # n = 64: shares of 16; at S = 32 query 15's frontier is split 2's last slot
    )                #   (47, in [32, 48)) and query 16's split 3's first (48)
    args, empty = _attention_inputs(torch.Generator(device="cuda").manual_seed(20), S, T, starts, lasts, quant)
    got, ref = _attend(args, S)
    assert empty[4].all() and (S != 32 or empty[3, 0])
    _held(got, ref, empty, S)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("B,T,splits", [(40, 100, 1), (1, 600, 8)])
def test_attention_at_one_split_and_the_most(B, T, splits, S, quant):
    """P = 1 (320 (row, head) pairs) and the largest P = 8 (one row, 600 slots)."""
    _need_card()
    assert pdecode.attention_plan(B, S, 32, 8, T, 128, quant)["splits"] == splits
    rng = torch.Generator().manual_seed(B)
    starts = torch.randint(0, T // 3, (B,), generator=rng).tolist()
    lasts = torch.randint(T // 2, T + 1, (B,), generator=rng).tolist()
    args, empty = _attention_inputs(torch.Generator(device="cuda").manual_seed(21), S, T, starts, lasts, quant)
    got, ref = _attend(args, S)
    _held(got, ref, empty, S)


@pytest.mark.gpu
def test_decode_at_the_w8_bench_shape():
    """B = 368, int8 cache of 160 slots, every row's frontier at 97 (the
    bench's mean): one split; two launches equal bit for bit."""
    _need_card()
    B, T = 368, 160
    assert pdecode.attention_plan(B, 1, 32, 8, T, 128, True)["splits"] == 1
    args, empty = _attention_inputs(torch.Generator(device="cuda").manual_seed(22), 1, T, [0] * B, [97] * B, True)
    got, ref = _attend(args, 1)
    _held(got, ref, empty, 1)
    assert torch.equal(got, pdecode.gqa_decode_attention(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("S", [1, 7])
def test_attention_repeats_bit_for_bit(S, quant):
    """The cluster merges its splits in split order: no atomics, so two
    launches on the same inputs are equal bit for bit (4 splits)."""
    _need_card()
    T = 400
    assert pdecode.attention_plan(8, S, 32, 8, T, 128, quant)["splits"] == 4
    args, _ = _attention_inputs(torch.Generator(device="cuda").manual_seed(23), S, T, [0, 5, 9, 100, 0, 1, 2, 3],
                                [400, 399, 300, 380, 17, 250, 128, 129], quant)
    one = _attend(args, S)[0]
    assert torch.equal(one, _attend(args, S)[0])


@pytest.mark.gpu
def test_attention_plan_invariants():
    """The kernel's cut (``attention_plan``): 1 ≤ P ≤ 8 (a cluster), a power
    of two, at most one split a tile of the cache, the same for the same
    shapes; P = 1 at the W8 bench (B · NKV = 2944), P ≥ 2 at the QA decode
    shape and 4-8 at the ARKit verify block; a block's warps and shared
    memory fit the card."""
    _need_card()
    for B in (1, 2, 4, 8, 33, 64, 368, 1024):
        for T in (1, 16, 63, 64, 65, 160, 215, 832, 4096):
            for S in (1, 7, 32):
                if S > T:
                    continue
                for quant in (False, True):
                    p = pdecode.attention_plan(B, S, 32, 8, T, 128, quant)
                    assert p == pdecode.attention_plan(B, S, 32, 8, T, 128, quant)
                    P = p["splits"]
                    assert P in (1, 2, 4, 8) and P <= -(-T // p["tile_slots"]), (B, T, S, p)
                    assert 32 * p["warps"] <= (128 if S == 1 else 256) and p["smem"] <= 232448, (B, T, S, p)
                    assert p["slots_per_warp"] in (16, 32, 64) and p["ring_stages"] >= 2
    assert pdecode.attention_plan(368, 1, 32, 8, 160, 128, True)["splits"] == 1
    assert pdecode.attention_plan(8, 1, 32, 8, 215, 128, False)["splits"] >= 2
    assert 4 <= pdecode.attention_plan(4, 7, 32, 8, 832, 128, False)["splits"] <= 8



# the tile edges of kernels 8 and 9 (128-row blocks, 64- and 128-row stages)
EDGE_ST = [(1, 1), (5, 5), (127, 127), (128, 128), (129, 129), (1029, 1029), (5, 129), (129, 5), (127, 1029),
           (1029, 128)]


def _edge_inputs(g, S, T, NH, NKV, D):
    """Three batch rows: every key; a frontier [T/3, T - T/5) (with
    ``causal`` its first queries see no key); no key at all (every query
    dead). 1e4 in every K/V slot outside the frontier."""
    B = 3
    q = torch.randn(B, S, NH, D, device="cuda", generator=g).bfloat16()
    k = torch.randn(B, T, NKV, D, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, T, NKV, D, device="cuda", generator=g).bfloat16()
    d_out = torch.randn(B, S, NH, D, device="cuda", generator=g).bfloat16()
    start = torch.tensor([0, T // 3, 0], dtype=torch.int32, device="cuda")
    end = torch.tensor([T, T - T // 5, 0], dtype=torch.int32, device="cuda")
    pos = torch.arange(T, device="cuda")
    outside = (pos[None] < start[:, None]) | (pos[None] >= end[:, None])  # [B, T]
    k.masked_fill_(outside[:, :, None, None], 1e4)
    v.masked_fill_(outside[:, :, None, None], 1e4)
    return q, k, v, d_out, start, end, outside


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,T", EDGE_ST)
def test_flash_backward_kernels_at_tile_edges(S, T, D, G, causal):
    """Kernels 8 and 9 against the plain backward where the tiles are ragged
    (S, T = 1, 5, 127, 128, 129, 1029, S != T too), with GQA groups 1 and 4,
    a frontier and dead rows: dead query rows and keys no query sees get
    exactly 0."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S * 7919 + T * 31 + D + G + causal)
    NKV = 2
    q, k, v, d_out, start, end, outside = _edge_inputs(g, S, T, NKV * G, NKV, D)
    kw = dict(causal=causal, kv_start=start, kv_end=end)
    out, lse = pflash.flash_attention_with_lse(q, k, v, **kw)
    got = pflash.flash_attention_backward(q, k, v, start, end, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    ref = pflash.flash_attention_backward_plain(q, k, v, start, end, out, lse, d_out, causal=causal)
    seen = ~outside[:, None, :]  # [B, S, T]: the keys each query sees
    if causal:
        seen = seen & (torch.arange(T, device="cuda")[None, :] <= torch.arange(S, device="cuda")[:, None])
    n_keys = seen.sum(-1)
    one_key = bool((n_keys[n_keys > 0] == 1).all())
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape and a.dtype == torch.bfloat16, name
        if one_key and name != "dv":
            # every live query sees one key (T = 1, or S = 1 with causal): p = 1
            # and dp = delta, so ds, dq and dk are 0 in exact arithmetic; both
            # versions give f32 rounding of dp - delta (|dp| ~ 8 here), of order
            # 1e-7, which no relative tolerance can compare
            assert max(a.abs().max().item(), r.abs().max().item()) <= 1e-5, (name, a.abs().max(), r.abs().max())
            continue
        assert agreement(a, r)["ok"], (name, agreement(a, r))
    dq, dk, dv = got
    dead = (lse <= -1e29).all(1)  # [B, S]: rows with no valid key
    assert dead[2].all() and not dq[dead].any()
    assert not dk[outside].any() and not dv[outside].any()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_kernels_read_strided_qkv_views(D):
    """q/k/v as views into one packed qkv (``qkv.chunk``, as the VGGT block
    hands them over) at the frame length 1029, against contiguous copies
    through the plain backward."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(14 + D)
    B, T, NH = 2, 1029, 4
    qkv = torch.randn(B, T, 3 * NH * D, device="cuda", generator=g).bfloat16()
    q, k, v = (t.reshape(B, T, NH, D) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous() and not v.is_contiguous()
    d_out = torch.randn(B, T, NH, D, device="cuda", generator=g).bfloat16()
    out, lse = pflash.flash_attention_with_lse(q, k, v)
    got = pflash.flash_attention_backward(q, k, v, None, None, out, lse, d_out)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    ref = pflash.flash_attention_backward_plain(qc, kc, vc, None, None, out, lse, d_out)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert agreement(a, r)["ok"], (name, agreement(a, r))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_repeat_bit_for_bit(causal):
    """No atomics: two runs on the same inputs give the same dq, dk and dv
    bit for bit (GQA group 4, so dk/dv sum over four heads)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v, d_out, start, end, _ = _edge_inputs(g, 1029, 1029, 8, 2, 64)
    out, lse = pflash.flash_attention_with_lse(q, k, v, causal=causal, kv_start=start, kv_end=end)
    a = pflash.flash_attention_backward(q, k, v, start, end, out, lse, d_out, causal=causal)
    b = pflash.flash_attention_backward(q, k, v, start, end, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))

# the tile edges of kernel 1 (128-row query tiles at D = 128 and D = 64, 192
# with three consumer warpgroups; 64- and 128-key stages)
FWD_EDGE_ST = [(1, 1), (5, 5), (127, 127), (128, 128), (129, 129), (191, 191), (192, 192), (193, 193),
               (1029, 1029), (5, 129), (129, 5), (127, 1029), (1029, 128), (191, 193), (193, 64), (192, 1029)]


def _held_fwd(q, k, v, start, end, causal):
    """Kernel 1's out and lse against the plain version's: out by
    ``utils.agreement``, lse within 1e-4 on rows that see a key; rows that see
    none exactly 0 with lse exactly -1e30. Returns (out, lse)."""
    kw = dict(causal=causal, kv_start=start, kv_end=end)
    n0 = pflash.launches
    out, lse = pflash.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert pflash.launches == n0 + 1
    ref, ref_lse = pflash.flash_attention_plain_with_lse(q, k, v, **kw)
    assert out.shape == ref.shape and lse.shape == ref_lse.shape and lse.dtype == torch.float32
    assert agreement(out, ref)["ok"], agreement(out, ref)
    live = ref_lse > -1e29  # [B, NH, S]
    torch.testing.assert_close(lse[live], ref_lse[live], rtol=0, atol=1e-4)
    assert (lse[~live] == -1e30).all()
    assert not out.transpose(1, 2)[~live].any(), "a query with no valid key must get exactly 0"
    return out, lse


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,T", FWD_EDGE_ST)
def test_flash_forward_at_tile_edges(S, T, D, G, causal):
    """Kernel 1 against its plain version where its tiles are ragged (S, T =
    1, 5, 127-129, 191-193, 1029, S != T too), GQA groups 1 and 4, a frontier
    with 1e4 in every K/V slot outside it, and a batch row with no key."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S * 7919 + T * 31 + D + G + causal + 1)
    q, k, v, _, start, end, _ = _edge_inputs(g, S, T, 2 * G, 2, D)
    out, lse = _held_fwd(q, k, v, start, end, causal)
    assert (lse[2] == -1e30).all() and not out[2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_forward_reads_strided_qkv_views(D, causal):
    """q/k/v as views into one packed qkv (``qkv.chunk``, as the VGGT block
    hands them over) at the frame length 1029: read through their strides,
    with no copy."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(16 + D + causal)
    B, T, NH = 2, 1029, 4
    qkv = torch.randn(B, T, 3 * NH * D, device="cuda", generator=g).bfloat16()
    q, k, v = (t.reshape(B, T, NH, D) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous() and not v.is_contiguous()
    copies = dict(pflash.fwd_copies)
    start = torch.tensor([0, 300], dtype=torch.int32, device="cuda")
    end = torch.tensor([T, 900], dtype=torch.int32, device="cuda")
    _held_fwd(q, k, v, start, end, causal)
    assert pflash.fwd_copies == copies


@pytest.mark.gpu
def test_flash_forward_copies_a_broadcast_view_the_kernel_refuses():
    """A broadcast (stride 0) k: the wrapper copies it and the result equals
    the contiguous inputs' bit for bit; the kernel's own wrapper refuses it."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(17)
    B, S, T, NH, D = 3, 200, 150, 4, 64
    q = torch.randn(B, S, NH, D, device="cuda", generator=g).bfloat16()
    k = torch.randn(1, T, NH, D, device="cuda", generator=g).bfloat16().expand(B, T, NH, D)
    v = torch.randn(B, T, NH, D, device="cuda", generator=g).bfloat16()
    n0 = pflash.fwd_copies["k"]
    got = pflash.flash_attention(q, k, v)
    assert pflash.fwd_copies["k"] == n0 + 1
    assert torch.equal(got, pflash.flash_attention(q, k.contiguous(), v))
    bounds = torch.zeros(B, dtype=torch.int32, device="cuda"), torch.full((B,), T, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="a TMA tensor map cannot address k"):
        pflash.flash_fwd_kernel(q, k, v, *bounds, False, D ** -0.5, False)


@pytest.mark.gpu
@pytest.mark.parametrize("D,G,causal", [(64, 1, False), (128, 4, True)])
def test_flash_forward_repeats_bit_for_bit(D, G, causal):
    """No atomics: two launches on the same inputs give the same output and
    lse bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(18 + D)
    q, k, v, _, start, end, _ = _edge_inputs(g, 1029, 1029, 2 * G, 2, D)
    kw = dict(causal=causal, kv_start=start, kv_end=end)
    a = pflash.flash_attention_with_lse(q, k, v, **kw)
    b = pflash.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_wrappers_raise_on_shapes_the_kernels_do_not_take():
    _need_card()
    x = torch.zeros(1, 8, 2, 32, device="cuda", dtype=torch.bfloat16)  # D = 32
    with pytest.raises(ValueError):
        pflash.flash_attention(x, x, x)
    with pytest.raises(ValueError):
        pflash.flash_attention(x.float(), x.float(), x.float())


# ---------------------------------------------------------------------------
# the W8 decode kernels (csrc/decode_matmul.cu)
# ---------------------------------------------------------------------------


def _w8(g, L, K, N):
    return {"w8": torch.randint(-127, 128, (L, K, N), device="cuda", generator=g, dtype=torch.int8),
            "scale": (torch.rand(L, 1, N, device="cuda", generator=g) * 0.002 + 0.001).bfloat16()}


def _head(g, V, H):
    return {"w8": torch.randint(-127, 128, (V, H), device="cuda", generator=g, dtype=torch.int8),
            "scale": (torch.rand(V, 1, device="cuda", generator=g) * 0.002 + 0.001).bfloat16()}


def decisive_rows(logits: torch.Tensor, rel: float = 1e-4) -> torch.Tensor:
    """Rows whose top-2 gap exceeds ``rel``·max|logit|: their argmax does not
    depend on the order of the f32 sums."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) > rel * logits.abs().amax()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 63, 368])
def test_w8_layer_kernels_match_plain(M):
    """QKV, WO and the SwiGLU MLP at Qwen3-4B's widths, at the last layer of
    a stacked weight (read by pointer offset)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    L, H, NQ, NKV, Fd = 2, 2560, 4096, 1024, 9728
    wq, wk, wv, wo = _w8(g, L, H, NQ), _w8(g, L, H, NKV), _w8(g, L, H, NKV), _w8(g, L, NQ, H)
    gate, up, down = _w8(g, L, H, Fd), _w8(g, L, H, Fd), _w8(g, L, Fd, H)
    x = torch.randn(M, H, device="cuda", generator=g).bfloat16()
    a = torch.randn(M, NQ, device="cuda", generator=g).bfloat16()
    li = L - 1
    n0 = dict(pdm.launches)
    got = [*pdm.fused_qkv_w8(x, wq, wk, wv, li), pdm.fused_linear_w8(a, wo, li),
           pdm.fused_mlp_w8(x * 0.05, gate, up, down, li)]
    torch.cuda.synchronize()
    assert all(pdm.launches[k] == n0[k] + 1 for k in ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8"))
    ref = [*pdm.fused_qkv_w8_plain(x, wq, wk, wv, li), pdm.fused_linear_w8_plain(a, wo, li),
           pdm.fused_mlp_w8_plain(x * 0.05, gate, up, down, li)]
    for name, o, r in zip(("q", "k", "v", "wo", "mlp"), got, ref):
        assert o.shape == r.shape and o.dtype == torch.bfloat16, name
        assert agreement(o, r)["ok"], (name, agreement(o, r))


@pytest.mark.gpu
def test_w8_qkv_split_edges():
    """Each output of the one QKV launch is, bit for bit, what a launch over
    its weight alone gives: the block grid's walk over wq|wk|wv tiles puts
    every tile where it belongs."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    L, H = 3, 128
    wq, wk, wv = _w8(g, L, H, 384), _w8(g, L, H, 128), _w8(g, L, H, 256)
    x = torch.randn(70, H, device="cuda", generator=g).bfloat16()
    for li in range(L):
        q, k, v = pdm.fused_qkv_w8(x, wq, wk, wv, li)
        for o, w in ((q, wq), (k, wk), (v, wv)):
            assert torch.equal(o, pdm.fused_linear_w8(x, w, li))
            assert agreement(o, pdm.fused_linear_w8_plain(x, w, li))["ok"]


@pytest.mark.gpu
@pytest.mark.parametrize("K", [2560, 4096])
@pytest.mark.parametrize("M", [1, 7, 8, 9, 28, 63, 184, 185, 192, 193, 256, 257, 368, 1024])
def test_w8_gemm_rows_at_tile_edges(M, K):
    """w8_gemm at the edges of its row tiling (row widths 8-128, row groups
    cut for one K part at 2560 deep and for four at 4096, the rows past M
    read as TMA's zero fill) over 640 channels: two whole 256-channel tiles
    and a half one."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(8)
    w = _w8(g, 2, K, 640)
    x = torch.randn(M, K, device="cuda", generator=g).bfloat16()
    got = pdm.fused_linear_w8(x, w, 1)
    ref = pdm.fused_linear_w8_plain(x, w, 1)
    assert got.shape == ref.shape and agreement(got, ref)["ok"], agreement(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [64, 2560, 4096, 9728])
@pytest.mark.parametrize("M", [8, 368])
def test_w8_gemm_depths(M, K):
    """Qwen3-4B's depths (QKV/MLP 2560, WO 4096, down 9728) and one 64-deep
    step: 1 to 8 K parts summed across the cluster."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    w = _w8(g, 2, K, 512)
    x = (torch.randn(M, K, device="cuda", generator=g) * 0.05).bfloat16()
    got = pdm.fused_linear_w8(x, w, 0)
    ref = pdm.fused_linear_w8_plain(x, w, 0)
    assert agreement(got, ref)["ok"], agreement(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 368])
def test_w8_qkv_with_half_tiles_equals_lone_launches(M):
    """Segments of 640, 128 and 384 channels (a 256-channel tile half full in
    each) at Qwen3-4B's depth: each output of the QKV launch equals, bit for
    bit, a launch over its weight alone, and agrees with the plain version."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(10)
    wq, wk, wv = _w8(g, 2, 2560, 640), _w8(g, 2, 2560, 128), _w8(g, 2, 2560, 384)
    x = torch.randn(M, 2560, device="cuda", generator=g).bfloat16()
    outs = pdm.fused_qkv_w8(x, wq, wk, wv, 1)
    for o, w in zip(outs, (wq, wk, wv)):
        assert torch.equal(o, pdm.fused_linear_w8(x, w, 1))
        assert agreement(o, pdm.fused_linear_w8_plain(x, w, 1))["ok"]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 368])
def test_w8_gemm_repeats_bit_for_bit(M):
    """No atomics: two launches on the same inputs give the same bits (QKV
    and WO at Qwen3-4B's widths)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(11)
    wq, wk, wv, wo = _w8(g, 1, 2560, 4096), _w8(g, 1, 2560, 1024), _w8(g, 1, 2560, 1024), _w8(g, 1, 4096, 2560)
    x = torch.randn(M, 2560, device="cuda", generator=g).bfloat16()
    a = torch.randn(M, 4096, device="cuda", generator=g).bfloat16()
    first = [*pdm.fused_qkv_w8(x, wq, wk, wv, 0), pdm.fused_linear_w8(a, wo, 0)]
    second = [*pdm.fused_qkv_w8(x, wq, wk, wv, 0), pdm.fused_linear_w8(a, wo, 0)]
    assert all(torch.equal(p, q) for p, q in zip(first, second))


@pytest.mark.gpu
def test_w8_gemm_reads_each_layer_by_pointer_offset():
    """The first and the last layer of a stacked [L, K, N] weight: each
    launch reads its own layer's weights and scales."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(12)
    L = 4
    w = _w8(g, L, 2560, 1024)
    x = torch.randn(368, 2560, device="cuda", generator=g).bfloat16()
    outs = {li: pdm.fused_linear_w8(x, w, li) for li in (0, L - 1)}
    for li, got in outs.items():
        ref = pdm.fused_linear_w8_plain(x, w, li)
        assert agreement(got, ref)["ok"], (li, agreement(got, ref))
    assert not torch.equal(outs[0], outs[L - 1])


@pytest.mark.gpu
def test_w8_gemm_plan_cuts_rows_and_depth_evenly():
    """The kernel's own cut of a launch (``w8_gemm_plan``): the M rows in
    equal row groups (none empty), each padded to the least row width that
    holds it; K in a power-of-two number of parts, at most 8 and at most K's
    64-deep steps; a ring of 2-8 stages whose shared memory fits a block.
    At Qwen3-4B's shapes it is the cut the H100 sweep chose."""
    _need_card()
    lib = pdm._lib()
    buf = (ctypes.c_int * 5)()
    widths = (8, 16, 32, 64, 80, 96, 128)

    def plan(M, K):
        assert lib.w8_gemm_plan(M, K, ctypes.addressof(buf)) == 0
        return tuple(buf)

    for M in sorted(set(range(1, 1100, 7)) | {8, 184, 185, 192, 193, 256, 257, 368, 1024}):
        for K in (64, 128, 2560, 4096, 9728):
            rows, groups, splits, stages, smem = plan(M, K)
            per = -(-M // groups)
            assert rows in widths and per <= rows and (groups - 1) * per < M, (M, K, rows, groups)
            assert all(r < per for r in widths if r < rows), (M, K, rows, per)
            assert splits in (1, 2, 4, 8) and splits <= K // 64, (M, K, splits)
            assert 2 <= stages <= 8 and smem <= 232448, (M, K, stages, smem)
    assert plan(368, 2560)[:3] == (80, 5, 1) and plan(368, 4096)[:3] == (128, 3, 4)
    assert plan(8, 2560)[:3] == (8, 1, 4) and plan(8, 9728)[:3] == (8, 1, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 63, 368])
def test_head_argmax_kernel_matches_plain(M):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    V, H = 151936, 2560
    head = _head(g, V, H)
    x = torch.randn(M, H, device="cuda", generator=g).bfloat16()
    n0 = pdm.launches["fused_head_argmax"]
    tok, mx = pdm.fused_head_argmax(x, head)
    torch.cuda.synchronize()
    assert pdm.launches["fused_head_argmax"] == n0 + 1
    logits = pdm.head_logits(x, head)
    ref_tok, ref_mx = pdm.fused_head_argmax_plain(x, head)
    ok = decisive_rows(logits)
    assert ok.float().mean() >= 0.99 or M < 100 and ok.sum() >= M - 1
    assert torch.equal(tok[ok], ref_tok[ok])
    torch.testing.assert_close(mx[ok], ref_mx[ok], rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("V", [128, 384, 151936])
@pytest.mark.parametrize("M", [1, 8, 79, 80, 81, 128, 129, 368])
def test_head_argmax_rows_and_vocab_edges(M, V):
    """The head at the edges of its row groups (widths 8-128, one to three
    groups) and of its 256-row vocab tiles: one half tile (V = 128), a whole
    and a half one (384), 593 whole and a half one (Qwen3's 151936); each
    launch counts one, and a second launch on the same inputs gives the same
    bits."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(13)
    H = 2560
    head = _head(g, V, H)
    x = torch.randn(M, H, device="cuda", generator=g).bfloat16()
    n0 = pdm.launches["fused_head_argmax"]
    tok, mx = pdm.fused_head_argmax(x, head)
    again = pdm.fused_head_argmax(x, head)
    torch.cuda.synchronize()
    assert pdm.launches["fused_head_argmax"] == n0 + 2
    assert torch.equal(tok, again[0]) and torch.equal(mx, again[1])
    logits = pdm.head_logits(x, head)
    ref_tok, ref_mx = pdm.fused_head_argmax_plain(x, head)
    ok = decisive_rows(logits)
    assert ok.sum() >= M - max(1, M // 100), (int(ok.sum()), M)
    assert torch.equal(tok[ok], ref_tok[ok])
    torch.testing.assert_close(mx[ok], ref_mx[ok], rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_head_argmax_ties_go_to_the_lowest_index():
    """Vocab rows 300, 301 (one tile), 1000 and 7000 (other tiles) are equal
    and hold the max: the token is 300."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    V, H = 8192, 256
    head = _head(g, V, H)
    for r in (300, 301, 1000, 7000):
        head["w8"][r] = head["w8"][7000]
        head["scale"][r] = 0.003  # above every other row's, so these rows hold the max
    x = (head["w8"][7000].float() / 127).bfloat16()[None].repeat(5, 1).contiguous()
    tok, _ = pdm.fused_head_argmax(x, head)
    assert tok.tolist() == [300] * 5, tok.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("V,rows", [
    (384, (130, 200)),                # one warpgroup's two tiles
    (384, (200, 300, 383)),           # a whole tile and the half tile after it
    (384, (300, 383)),                # inside the half tile
    (151936, (151935, 151809, 40000)),  # the half tile and a tile far before it
    (151936, (151935, 151809)),       # inside the last (half) tile
    (151936, (255, 256)),             # across two tiles' edge
])
def test_head_argmax_ties_across_tiles_and_the_half_tile(V, rows):
    """Equal rows holding the max, inside a tile, across tiles and in the
    half tile at the end of the vocab: the token is the lowest of them, at
    one row and at 368 (three row groups)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(14)
    H = 2560
    head = _head(g, V, H)
    for r in rows:
        head["w8"][r] = head["w8"][rows[0]]
        head["scale"][r] = 0.003  # above every other row's
    x = (head["w8"][rows[0]].float() / 127).bfloat16()[None]
    for M in (1, 368):
        tok, mx = pdm.fused_head_argmax(x.repeat(M, 1).contiguous(), head)
        assert tok.tolist() == [min(rows)] * M, (M, tok.unique().tolist())
        torch.testing.assert_close(mx, pdm.head_logits(x, head)[0, min(rows)].repeat(M), rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_head_argmax_takes_plus_and_minus_zero_as_equal():
    """-0.0 and +0.0 are one value, as in torch.argmax. Every scale is
    negative but row 301's, every int8 positive but rows 250 and 301's
    (zero). A zero x row has every logit -0.0 but row 301's +0.0: the token
    is 0. A positive x row has every logit negative but rows 250 (-0.0) and
    301 (+0.0): the token is 250, in the first of two tiles."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(15)
    V, H = 384, 256
    head = {"w8": torch.randint(1, 128, (V, H), device="cuda", generator=g, dtype=torch.int8),
            "scale": torch.full((V, 1), -0.002, device="cuda").bfloat16()}
    head["w8"][[250, 301]] = 0
    head["scale"][301] = 0.002
    x = torch.zeros(3, H, device="cuda").bfloat16()
    x[1:] = 0.5
    tok, mx = pdm.fused_head_argmax(x, head)
    ref_tok, _ = pdm.fused_head_argmax_plain(x, head)
    assert tok.tolist() == ref_tok.tolist() == [0, 250, 250], (tok.tolist(), ref_tok.tolist())
    assert mx.tolist() == [0.0, 0.0, 0.0] and bool(torch.signbit(mx).all())  # rows 0's and 250's -0.0


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps apart a and b are (+0.0 and -0.0 one value)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _swiglu_inputs(g, M, K, F, L=2):
    """x [M, K] and stacked gate/up [L, K, F] (g and u of the order of one)."""
    x = (torch.randn(M, K, device="cuda", generator=g) * (2.0 / K ** 0.5)).bfloat16()
    return x, _w8(g, L, K, F), _w8(g, L, K, F)


def _activation(x, gate, up, li):
    """The gate/up launch alone: fused_mlp_w8's activation a [M, F], the
    down launch's input."""
    return pdm._swiglu("w8_swiglu", x, gate, up, li)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [64, 128, 2560, 4096])
@pytest.mark.parametrize("M", [1, 8, 63, 64, 80, 81, 368])
def test_w8_swiglu_equals_silu_mul_of_two_w8_gemm_launches(M, K):
    """The gate/up launch takes w8_gemm's cut of (M, K) (one K part or
    several, row widths 8-128), so its g and u are the bits of
    fused_linear_w8 over gate and over up: its activation equals
    bf16(silu(g)) * u of those two launches within one bf16 step (the
    exponential's last bit), and agrees with the plain version. F = 384:
    three 128-channel gate/up blocks (w8_gemm over either weight: a whole
    256-channel tile and a half one); the last layer of two, by pointer
    offset."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(16)
    F = 384
    x, gate, up = _swiglu_inputs(g, M, K, F)
    a = _activation(x, gate, up, 1)
    gv, uv = pdm.fused_linear_w8(x, gate, 1), pdm.fused_linear_w8(x, up, 1)
    ref = torch.nn.functional.silu(gv) * uv
    assert a.shape == (M, F) and a.dtype == torch.bfloat16
    assert int(_ulps(a, ref).max()) <= 1, int(_ulps(a, ref).max())
    plain = torch.nn.functional.silu(pdm.fused_linear_w8_plain(x, gate, 1)) * pdm.fused_linear_w8_plain(x, up, 1)
    assert agreement(a, plain)["ok"], agreement(a, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 368])
def test_w8_swiglu_reads_each_layer_and_repeats_bit_for_bit(M):
    """The first and the last layer of a stacked weight at Qwen3-4B's widths
    (K 2560, F 9728): each launch reads its own layer's gate, up and scales,
    and two launches on the same inputs give the same bits."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(17)
    L = 3
    x, gate, up = _swiglu_inputs(g, M, 2560, 9728, L=L)
    outs = {}
    for li in (0, L - 1):
        outs[li] = _activation(x, gate, up, li)
        assert torch.equal(outs[li], _activation(x, gate, up, li))
        plain = torch.nn.functional.silu(pdm.fused_linear_w8_plain(x, gate, li)) * \
            pdm.fused_linear_w8_plain(x, up, li)
        assert agreement(outs[li], plain)["ok"], (li, agreement(outs[li], plain))
    assert not torch.equal(outs[0], outs[L - 1])


@pytest.mark.gpu
def test_w8_wrappers_raise_on_shapes_the_kernels_do_not_take():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(7)
    w = _w8(g, 2, 128, 256)
    x = torch.randn(4, 128, device="cuda", generator=g).bfloat16()
    with pytest.raises(ValueError):  # K not a multiple of 64
        pdm.fused_linear_w8(torch.zeros(4, 96, device="cuda", dtype=torch.bfloat16), _w8(g, 1, 96, 128), 0)
    with pytest.raises(ValueError):  # N not a multiple of 128
        pdm.fused_linear_w8(x, _w8(g, 1, 128, 192), 0)
    with pytest.raises(ValueError):  # f32 activations
        pdm.fused_linear_w8(x.float(), w, 0)
    with pytest.raises(ValueError):  # not contiguous
        pdm.fused_linear_w8(torch.zeros(128, 4, device="cuda", dtype=torch.bfloat16).t(), w, 0)
    with pytest.raises(ValueError):  # no such layer
        pdm.fused_linear_w8(x, w, 2)
    with pytest.raises(ValueError):  # vocab not a multiple of 128
        pdm.fused_head_argmax(x, _head(g, 200, 128))
    with pytest.raises(ValueError):  # F not a multiple of 128
        pdm.fused_mlp_w8(x, _w8(g, 1, 128, 192), _w8(g, 1, 128, 192), _w8(g, 1, 192, 128), 0)
