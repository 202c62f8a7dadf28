"""Each CUDA kernel of the port against its plain PyTorch version on the card.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up for the CPU
suite.) Whether a card is present is decided inside each test body, so every
pytest worker collects the same tests; without a card they skip.
Tolerance: ``utils.agreement`` with tol 2e-2, scaled to the reference (every
element within 2e-2·max|ref| + 2e-2·|ref|, ‖err‖₂ ≤ 5e-3·‖ref‖₂); rows with
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
