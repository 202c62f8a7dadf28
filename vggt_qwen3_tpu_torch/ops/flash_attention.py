"""Flash attention: the CUDA kernels' wrappers, their plain versions and the
autograd function that joins the forward to its backward.

Counterpart of ``vggt_qwen3_tpu/ops/flash_attention.py``:

- forward, the Pallas ``_flash_kernel`` (``csrc/flash_fwd.cu``), with an
  optional per-row logsumexp output;
- backward, the Pallas ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``
  (``csrc/flash_bwd.cu``): P recomputed from the saved logsumexp, dq from a
  sweep over the keys, dk/dv from a sweep over the GQA group's heads × the
  queries.

Serves VGGT frame attention (``[B·V, 1029]`` tokens at 448², D=64), VGGT
global attention (``[B, 8232]``) and the causal, left-padded Qwen3 prefill
(D=128, 32/8 heads). Training differentiates the VGGT attentions when the
vision tower is not frozen.

Forward numerics (kernel and plain version alike): QK at the input precision
with f32 accumulation, the scale applied to the f32 scores, a per-row
``[kv_start, kv_end)`` frontier plus optional slot-causal mask, f32 softmax
statistics, the unnormalised P cast to ``v.dtype`` before an f32-accumulated
PV, output ``acc / max(l, 1e-20)`` — a row with no valid key gives 0 — and
``lse = m + log(max(l, 1e-30))``, ``-1e30`` on such a dead row.

Backward numerics, the JAX kernels' (``flash_attention.py:363-505``), not
autograd's: ``delta = rowsum(f32(dO)·f32(out))`` from the rounded output,
minus the lse cotangent where there is one; ``p = exp(s − lse)`` with dead
rows forced to 0; ``dp = dO·Vᵀ`` at the input precision with f32 sums;
``ds = p·(dp − delta)``; ``dq = scale·(ds @ K)``, ``dk = scale·(dsᵀ @ Q)``,
``dv = pᵀ @ dO``. The plain version keeps p and ds in f32 as the TPU
kernels do; the CUDA kernels round them to bf16 for the tensor cores (see
``csrc/flash_bwd.cu``). The kv bounds get no gradient.

:func:`flash_attention` goes through :class:`FlashAttention` (an
``autograd.Function``) whenever an input requires grad, on either device;
otherwise it calls the forward directly and writes no lse.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernel_build

NEG_INF = -1e30

# Incremented once per kernel launch (never for the plain versions):
# ``launches`` for the forward, ``dq_launches`` and ``dkv_launches`` for the
# two backward kernels.
launches = 0
dq_launches = 0
dkv_launches = 0


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 sums, or f64 for f64 inputs (the gradient check)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _valid_mask(B, S, T, device, causal, kv_start, kv_end) -> torch.Tensor:
    """[B, 1, 1, S, T] bool: key slot t may be seen by query slot s."""
    kv_pos = torch.arange(T, device=device)
    valid = torch.ones((B, 1, 1, S, T), dtype=torch.bool, device=device)
    if kv_start is not None:
        valid = valid & (kv_pos[None, :] >= kv_start.long()[:, None])[:, None, None, None, :]
    if kv_end is not None:
        valid = valid & (kv_pos[None, :] < kv_end.long()[:, None])[:, None, None, None, :]
    if causal:
        valid = valid & (kv_pos[None, :] <= torch.arange(S, device=device)[:, None])
    return valid


def _plain_scores(q, k, scale, causal, kv_start, kv_end):
    """Masked scaled scores [B, NKV, G, S, T] (−inf where masked)."""
    B, S, NH, D = q.shape
    T, NKV = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    qg = q.reshape(B, S, NKV, NH // NKV, D).to(acc)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(acc)) * scale
    return s.masked_fill(~_valid_mask(B, S, T, q.device, causal, kv_start, kv_end), float("-inf"))


def flash_attention_plain_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    kv_start: Optional[torch.Tensor] = None,
    kv_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialised-scores forward with the kernel's numerics.

    q [B, S, NH, D]; k, v [B, T, NKV, D]; kv_start/kv_end [B] int.
    Returns (out [B, S, NH, D] in q.dtype, lse [B, NH, S] f32 — f64 for f64
    inputs — with ``-1e30`` on rows with no valid key)."""
    B, S, NH, D = q.shape
    NKV = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    acc = _acc_dtype(q)
    s = _plain_scores(q, k, scale, causal, kv_start, kv_end)
    m = s.amax(-1, keepdim=True)
    dead = torch.isneginf(m)
    m = torch.where(dead, torch.zeros_like(m), m)  # dead row: p = 0
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # [B, NKV, G, S, 1]
    pv = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).to(acc), v.to(acc))
    out = pv / l.clamp_min(1e-20).squeeze(-1).permute(0, 3, 1, 2)[..., None]
    lse = torch.where(dead, torch.full_like(m, NEG_INF), m + torch.log(l.clamp_min(1e-30)))
    return out.reshape(B, S, NH, D).to(q.dtype), lse.reshape(B, NH, S)


def flash_attention_plain(q, k, v, **kw) -> torch.Tensor:
    """:func:`flash_attention_plain_with_lse` without the lse."""
    return flash_attention_plain_with_lse(q, k, v, **kw)[0]


def flash_attention_backward_plain(
    q, k, v, kv_start, kv_end, out, lse, d_out, g_lse=None, *,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialised backward with the JAX kernels' numerics (module note).

    out is the forward's (rounded) output, lse its [B, NH, S] logsumexp,
    d_out the cotangent of out, g_lse that of lse or None. Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    B, S, NH, D = q.shape
    T, NKV = k.shape[1], k.shape[2]
    G = NH // NKV
    if scale is None:
        scale = D ** -0.5
    acc = _acc_dtype(q)
    delta = (d_out.to(acc) * out.to(acc)).sum(-1).permute(0, 2, 1)  # [B, NH, S]
    if g_lse is not None:
        delta = delta - g_lse.to(acc)
    lse_g = lse.to(acc).reshape(B, NKV, G, S, 1)
    s = _plain_scores(q, k, scale, causal, kv_start, kv_end)
    p = torch.exp(s - lse_g)  # exp(−inf) = 0 on masked entries
    p = torch.where(lse_g <= NEG_INF * 0.5, torch.zeros_like(p), p)  # dead rows
    dog = d_out.reshape(B, S, NKV, G, D)
    dp = torch.einsum("bskgd,btkd->bkgst", dog.to(acc), v.to(acc))
    ds = p * (dp - delta.reshape(B, NKV, G, S, 1))
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.reshape(B, S, NKV, G, D).to(acc)) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog.to(acc))
    return dq.reshape(B, S, NH, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------


def _fwd_lib():
    fn = kernel_build.load("flash_fwd").lib.flash_fwd_bf16
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I] + [LL] * 9 + [ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib(name: str):
    fn = getattr(kernel_build.load("flash_bwd").lib, name)
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        n_out = 1 if name == "flash_bwd_dq_bf16" else 2
        fn.argtypes = [P] * (4 + 4 + n_out) + [I] * 7 + [LL] * 12 + [ctypes.c_float, I, P]
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


def _tma_addressable(x: torch.Tensor) -> bool:
    """Whether the backward kernels' TMA tensor maps can address the
    [B, S, H, D] view x: a contiguous head dim, a 16-byte aligned base, the
    other strides multiples of 16 bytes below 2^40 bytes, and none 0
    (broadcast) on a dimension of more than one element."""
    es = x.element_size()
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        (s > 0 or n == 1) and s * es % 16 == 0 and s * es < 2**40 for s, n in zip(x.stride()[:-1], x.shape[:-1]))


def _check_tma(name: str, x: torch.Tensor, device) -> None:
    _check_operand(name, x, device)
    if not _tma_addressable(x):
        raise ValueError(
            f"flash_attention backward: a TMA tensor map cannot address {name} "
            f"(shape {tuple(x.shape)}, strides {x.stride()}): it needs positive strides below 2^40 bytes"
        )


def _check_kernel_shapes(q, k, v) -> None:
    B, S, NH, D = q.shape
    Bk, T, NKV, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D or NH % NKV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head dim 64 or 128, got {D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device)


def _bounds(x, B: int, default: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((B,), default, dtype=torch.int32, device=device)
    if x.shape != (B,):
        raise ValueError(f"flash_attention: kv bounds must have shape ({B},), got {tuple(x.shape)}")
    return x.to(device=device, dtype=torch.int32).contiguous()


def _strides3(x):
    return x.stride(0), x.stride(1), x.stride(2)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


BWD_STAT_TILE = 128  # lse/delta rows hold whole query tiles of both backward kernels (flash_bwd.cu refuses others)


def _stat_buffer(B: int, NH: int, S: int, fill: float, device) -> torch.Tensor:
    """A [B, NH, S_pad] f32 buffer of ``fill``, S_pad the next multiple of
    BWD_STAT_TILE: the backward kernels read lse and delta a tile at a time
    by bulk copies, which need 16-byte aligned whole slices (rows of S = 1029
    are not). Past S, lse is −1e30 (a dead row) and delta 0."""
    S_pad = -(-S // BWD_STAT_TILE) * BWD_STAT_TILE
    return torch.full((B, NH, S_pad), fill, dtype=torch.float32, device=device)


def flash_fwd_kernel(q, k, v, start, end, causal: bool, scale: float, with_lse: bool):
    """Launch ``csrc/flash_fwd.cu``: (out [B, S, NH, D] bf16, lse [B, NH, S]
    f32 or None). start/end are [B] int32 on the card."""
    global launches
    B, S, NH, D = q.shape
    T, NKV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, NH, D), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, NH, S), dtype=torch.float32, device=q.device) if with_lse else None
    rc = _fwd_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        start.data_ptr(), end.data_ptr(),
        B, S, T, NH, NKV, D,
        *_strides3(q), *_strides3(k), *_strides3(v),
        float(scale), int(bool(causal)), _stream(q),
    )
    kernel_build.check(rc, "flash_fwd")
    launches += 1
    return out, lse


def flash_bwd_kernels(q, k, v, start, end, lse, delta, d_out, causal: bool, scale: float):
    """Launch ``csrc/flash_bwd.cu``'s two kernels: (dq, dk, dv) in bf16.
    lse is [B, NH, S] f32, copied here into a padded buffer; delta is one
    already, [B, NH, S_pad] f32 (:func:`_stat_buffer`), as
    :func:`flash_attention_backward` writes it. q, k, v and d_out are read
    through TMA tensor maps over their strides (:func:`_check_tma`)."""
    global dq_launches, dkv_launches
    B, S, NH, D = q.shape
    T, NKV = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v), ("d_out", d_out)):
        _check_tma(name, x, q.device)
    lse_p = _stat_buffer(B, NH, S, NEG_INF, q.device)
    lse_p[..., :S] = lse
    if delta.shape != lse_p.shape or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError(f"flash_attention backward: delta must be a contiguous f32 {tuple(lse_p.shape)}, "
                         f"got {delta.dtype} {tuple(delta.shape)}")
    common = (B, S, T, NH, NKV, D, lse_p.shape[-1], *_strides3(q), *_strides3(k), *_strides3(v),
              *_strides3(d_out), float(scale), int(bool(causal)), _stream(q))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
           lse_p.data_ptr(), delta.data_ptr(), start.data_ptr(), end.data_ptr())
    dq = torch.empty((B, S, NH, D), dtype=torch.bfloat16, device=q.device)
    kernel_build.check(_bwd_lib("flash_bwd_dq_bf16")(*ins, dq.data_ptr(), *common), "flash_bwd_dq")
    dq_launches += 1
    dk = torch.empty((B, T, NKV, D), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty((B, T, NKV, D), dtype=torch.bfloat16, device=q.device)
    kernel_build.check(_bwd_lib("flash_bwd_dkv_bf16")(*ins, dk.data_ptr(), dv.data_ptr(), *common),
                       "flash_bwd_dkv")
    dkv_launches += 1
    return dq, dk, dv


def _on_card(x: torch.Tensor) -> bool:
    """Kernel or plain version: by the device of the tensor, nothing else."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"flash_attention: unsupported device {x.device}")


def _forward(q, k, v, kv_start, kv_end, causal, scale, with_lse):
    """(out, lse or None) from the kernel (CUDA) or the plain version (CPU)."""
    if not _on_card(q):
        out, lse = flash_attention_plain_with_lse(
            q, k, v, causal=causal, kv_start=kv_start, kv_end=kv_end, scale=scale)
        return out, (lse if with_lse else None)
    _check_kernel_shapes(q, k, v)
    B, T = q.shape[0], k.shape[1]
    return flash_fwd_kernel(q, k, v, _bounds(kv_start, B, 0, q.device), _bounds(kv_end, B, T, q.device),
                            causal, scale, with_lse)


def flash_attention_backward(q, k, v, kv_start, kv_end, out, lse, d_out, g_lse=None, *,
                             causal: bool = False, scale: Optional[float] = None):
    """(dq, dk, dv): kernels 8 and 9 for CUDA tensors, else
    :func:`flash_attention_backward_plain`. δ is taken here in plain torch
    (it was XLA in the JAX package)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not _on_card(q):
        return flash_attention_backward_plain(q, k, v, kv_start, kv_end, out, lse, d_out, g_lse,
                                              causal=causal, scale=scale)
    _check_kernel_shapes(q, k, v)
    B, S, NH, _ = q.shape
    T = k.shape[1]
    delta = _stat_buffer(B, NH, S, 0.0, q.device)  # δ goes straight into the kernels' padded rows
    torch.sum(d_out.float() * out.float(), -1, out=delta[..., :S].transpose(1, 2))
    if g_lse is not None:
        delta[..., :S] -= g_lse.float()
    # broadcast views (autograd's cotangents, expanded inputs) are copied for the TMA maps
    q, k, v, d_out = (x if _tma_addressable(x) else x.clone(memory_format=torch.contiguous_format)
                      for x in (q, k, v, d_out))
    return flash_bwd_kernels(q, k, v, _bounds(kv_start, B, 0, q.device), _bounds(kv_end, B, T, q.device),
                             lse, delta, d_out, causal, scale)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: (out, lse) from q, k, v and the
    kv bounds; the bounds get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start, kv_end, causal: bool, scale: float):
        out, lse = _forward(q, k, v, kv_start, kv_end, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, kv_start, kv_end, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, g_lse):
        q, k, v, kv_start, kv_end, out, lse = ctx.saved_tensors
        if d_out is None:
            d_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward(q, k, v, kv_start, kv_end, out, lse, d_out, g_lse,
                                              causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    kv_start: Optional[torch.Tensor] = None,
    kv_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention`, also returning the per-row logsumexp
    ([B, NH, S] f32; rows with no valid key hold ``-1e30``). Differentiable
    in both outputs: the lse cotangent folds into the backward's delta."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, kv_start, kv_end, causal, scale)
    return _forward(q, k, v, kv_start, kv_end, causal, scale, with_lse=True)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False,
    kv_start: Optional[torch.Tensor] = None,
    kv_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention, layouts as :func:`ops.attention.mha`.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (bf16, D ∈ {64, 128}) or raise. With an input that requires grad the
    call goes through :class:`FlashAttention`, whose backward is kernels 8
    and 9 on the card and :func:`flash_attention_backward_plain` on the CPU.

    Args:
        q: [B, S, NH, D]; k, v: [B, T, NKV, D], NH % NKV == 0. Read through
            their strides (the head dim must be contiguous).
        causal: slot-causal mask (query slot i sees kv slots ≤ i).
        kv_start/kv_end: [B] int valid-slot bounds; default all slots.
    Returns:
        [B, S, NH, D] in q.dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, kv_start, kv_end, causal, scale)[0]
    return _forward(q, k, v, kv_start, kv_end, causal, scale, with_lse=False)[0]
