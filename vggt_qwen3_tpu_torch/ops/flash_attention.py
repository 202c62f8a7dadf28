"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``vggt_qwen3_tpu/ops/flash_attention.py`` (the Pallas
``_flash_kernel`` via ``flash_attention``). Serves VGGT frame attention
(``[B·V, 1029]`` tokens at 448², D=64), VGGT global attention (``[B, 8232]``)
and the causal, left-padded Qwen3 prefill (D=128, 32/8 heads).

Numerics (kernel and plain version alike): QK at the input precision with
f32 accumulation, the scale applied to the f32 scores, a per-row
``[kv_start, kv_end)`` frontier plus optional slot-causal mask, f32 softmax
statistics, the unnormalised P cast to ``v.dtype`` before an f32-accumulated
PV, output ``acc / max(l, 1e-20)`` — a row with no valid key gives 0.

Forward only; the backward and the lse output wait for the training and
ring-attention slices (ROADMAP).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernel_build

# Incremented once per kernel launch (never for the plain version).
launches = 0


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    kv_start: Optional[torch.Tensor] = None,
    kv_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Materialised-scores version with the kernel's numerics.

    q [B, S, NH, D]; k, v [B, T, NKV, D]; kv_start/kv_end [B] int."""
    B, S, NH, D = q.shape
    T, NKV = k.shape[1], k.shape[2]
    G = NH // NKV
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, S, NKV, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    kv_pos = torch.arange(T, device=q.device)
    valid = torch.ones((B, 1, 1, S, T), dtype=torch.bool, device=q.device)
    if kv_start is not None:
        valid = valid & (kv_pos[None, :] >= kv_start.long()[:, None])[:, None, None, None, :]
    if kv_end is not None:
        valid = valid & (kv_pos[None, :] < kv_end.long()[:, None])[:, None, None, None, :]
    if causal:
        valid = valid & (kv_pos[None, :] <= torch.arange(S, device=q.device)[:, None])
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)  # dead row: p = 0
    p = torch.exp(s - m)
    l = p.sum(-1)  # [B, NKV, G, S]
    pv = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    out = pv / l.clamp_min(1e-20).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, NH, D).to(q.dtype)


def _lib():
    kl = kernel_build.load("flash_fwd")
    fn = kl.lib.flash_fwd_bf16
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I] + [LL] * 9 + [ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check_operand(name: str, x: torch.Tensor, device) -> None:
    if x.device != device:
        raise ValueError(f"flash_attention: {name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention kernel takes bf16, {name} is {x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} needs a contiguous head dim, strides that are "
            f"multiples of 8 elements and a 16-byte aligned base (strides {x.stride()})"
        )


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    kv_start: Optional[torch.Tensor] = None,
    kv_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention forward, layouts as :func:`ops.attention.mha`.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    ``csrc/flash_fwd.cu`` kernel (bf16, D ∈ {64, 128}) or raise.

    Args:
        q: [B, S, NH, D]; k, v: [B, T, NKV, D], NH % NKV == 0. Read through
            their strides (the head dim must be contiguous).
        causal: slot-causal mask (query slot i sees kv slots ≤ i).
        kv_start/kv_end: [B] int valid-slot bounds; default all slots.
    Returns:
        [B, S, NH, D] in q.dtype.
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, NH, D = q.shape
    Bk, T, NKV, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D or NH % NKV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head dim 64 or 128, got {D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device)
    if scale is None:
        scale = D ** -0.5

    def bounds(x, default):
        if x is None:
            return torch.full((B,), default, dtype=torch.int32, device=q.device)
        if x.shape != (B,):
            raise ValueError(f"flash_attention: kv bounds must have shape ({B},), got {tuple(x.shape)}")
        return x.to(device=q.device, dtype=torch.int32).contiguous()

    start = bounds(kv_start, 0)
    end = bounds(kv_end, T)
    out = torch.empty((B, S, NH, D), dtype=torch.bfloat16, device=q.device)
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        start.data_ptr(), end.data_ptr(),
        B, S, T, NH, NKV, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_build.check(rc, "flash_fwd")
    launches += 1
    return out
