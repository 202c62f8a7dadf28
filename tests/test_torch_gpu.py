"""Each CUDA kernel of the port against its plain PyTorch version on the card.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up for the CPU
suite.) Whether a card is present is decided inside each test body, so every
pytest worker collects the same tests; without a card they skip.
Tolerance: ``utils.agreement`` with tol 2e-2, scaled to the reference (every
element within 2e-2·max|ref| + 2e-2·|ref|, ‖err‖₂ ≤ 5e-3·‖ref‖₂); rows with
no valid key exactly 0.
"""

import pytest
import torch

from vggt_qwen3_tpu_torch.ops import decode_attention as pdecode
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


@pytest.mark.gpu
def test_wrappers_raise_on_shapes_the_kernels_do_not_take():
    _need_card()
    x = torch.zeros(1, 8, 2, 32, device="cuda", dtype=torch.bfloat16)  # D = 32
    with pytest.raises(ValueError):
        pflash.flash_attention(x, x, x)
    with pytest.raises(ValueError):
        pflash.flash_attention(x.float(), x.float(), x.float())
