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
