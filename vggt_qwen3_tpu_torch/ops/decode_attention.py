"""GQA decode attention over the stacked head-major KV cache: the CUDA
kernels' wrappers and their plain versions.

Counterpart of ``vggt_qwen3_tpu/ops/decode_attention.py`` (the Pallas
``_decode_kernel``, reached through ``gqa_decode_attention`` and
``gqa_block_verify_attention``):

- :func:`gqa_decode_attention`: one query token per row attends to the
  slots ``[kv_start, kv_end)``;
- :func:`gqa_block_verify_attention`: the speculative verify block, S query
  tokens per row, query j attending to ``[kv_start, kv_off + 1 + j)``
  (in-block causality at per-row depths).

Both launch one kernel body of ``csrc/decode_attention.cu`` (decode is the
verify block with S = 1), under two kernel names and two launch counters.
How a launch is cut (splits of the cache per row, warps, shared memory) is
the source's own plan, a function of the shapes alone: :func:`attention_plan`.

Both read layer ``li`` of the whole stacked cache ``[L, B, NKV, T, D]``.
``cache[li]`` is a view in PyTorch, and the kernels read the layer by
pointer offset, so no per-layer copy is made.

Numerics (kernel and plain version alike):
- bf16 cache: f32 QK, scores × D^-0.5, f32 softmax, f32 PV;
- int8 cache (bf16 per-(token, head) scales ``ks``/``vs`` [L, B, NKV, T]):
  scores × (ks · D^-0.5), the row sum ``l`` taken before ``p`` is multiplied
  by ``vs``, f32 PV over the int8 values;
- output divided by ``max(l, 1e-20)``; a query with no valid slot gives 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernel_build

# Incremented once per kernel launch (never for the plain versions):
# ``launches`` for the decode kernel, ``verify_launches`` for block verify.
launches = 0
verify_launches = 0

MAX_GROUP = 8  # query heads per kv head the decode kernel supports
MAX_VERIFY_ROWS = 128  # S · (NH / NKV) score rows the block-verify kernel supports


def gqa_decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, li: int,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """q [B, NH, D]; k, v [L, B, NKV, T, D]; → [B, NH, D] in q.dtype."""
    B, NH, D = q.shape
    NKV, T = k.shape[2], k.shape[3]
    G = NH // NKV
    if scale is None:
        scale = D ** -0.5
    start = kv_start.long().clamp(0, T)
    end = kv_end.long().clamp(0, T)
    s = torch.einsum("bkgd,bktd->bkgt", q.reshape(B, NKV, G, D).float(), k[li].float())
    if ks is not None:
        s = s * (ks[li].float()[:, :, None, :] * scale)
    else:
        s = s * scale
    pos = torch.arange(T, device=q.device)
    valid = (pos[None, :] >= start[:, None]) & (pos[None, :] < end[:, None])
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if vs is not None:
        p = p * vs[li].float()[:, :, None, :]
    pv = torch.einsum("bkgt,bktd->bkgd", p, v[li].float())
    return (pv / l.clamp_min(1e-20)).reshape(B, NH, D).to(q.dtype)


def _lib():
    lib = kernel_build.load("decode_attention").lib
    if lib.decode_attention.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention.argtypes = [P] * 8 + [I] * 6 + [F, P]
        lib.decode_attention.restype = I
        lib.block_verify_attention.argtypes = [P] * 8 + [I] * 7 + [F, P]
        lib.block_verify_attention.restype = I
        lib.attention_plan.argtypes = [I] * 7 + [P]
        lib.attention_plan.restype = I
    return lib


def attention_plan(B: int, S: int, NH: int, NKV: int, T: int, D: int, quant: bool) -> dict:
    """The kernel's own cut of a launch (``attention_plan`` in
    ``csrc/decode_attention.cu``, built on first use): ``splits`` of each
    row's cache (one thread-block cluster), ``warps`` a block,
    ``slots_per_warp`` of each tile, dynamic shared memory ``smem`` bytes,
    ``tile_slots``, ``ring_stages``, and from the CUDA occupancy calculator
    ``blocks_per_sm`` and ``clusters`` (the most the card holds at once).
    Decode is S = 1."""
    buf = (ctypes.c_int * 8)()
    kernel_build.check(_lib().attention_plan(B, S, NH, NKV, T, D, int(quant), ctypes.addressof(buf)),
                       "attention_plan")
    return dict(zip(("splits", "warps", "slots_per_warp", "smem", "tile_slots", "ring_stages", "blocks_per_sm",
                     "clusters"), buf))


def gqa_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, li: int,
    kv_start: torch.Tensor, kv_end: torch.Tensor,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token GQA decode attention over the stacked cache.

    CPU tensors take :func:`gqa_decode_attention_plain`; CUDA tensors launch
    the ``csrc/decode_attention.cu`` kernel (``decode_kernel``) or raise.
    The kernel takes bf16 ``q``, a contiguous bf16 or int8 cache (int8 with
    bf16 ``ks``/``vs``), D ∈ {64, 128} and at most 8 query heads per kv
    head.
    """
    global launches
    if q.device.type == "cpu":
        return gqa_decode_attention_plain(q, k, v, li, kv_start, kv_end, ks, vs, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_decode_attention: unsupported device {q.device}")
    B, NH, D = q.shape
    L, Bk, NKV, T, Dk = k.shape
    quant = k.dtype == torch.int8
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D or NH % NKV:
        raise ValueError(f"gqa_decode_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in (64, 128) or NH // NKV > MAX_GROUP:
        raise ValueError(f"gqa_decode_attention kernel takes D in (64, 128) and group <= {MAX_GROUP}")
    if not 0 <= int(li) < L:
        raise ValueError(f"gqa_decode_attention: layer {li} outside [0, {L})")
    if q.dtype != torch.bfloat16 or k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype:
        raise ValueError(f"gqa_decode_attention kernel takes bf16 q and a bf16 or int8 cache, got {q.dtype}/{k.dtype}/{v.dtype}")
    if quant != (ks is not None) or quant != (vs is not None):
        raise ValueError("gqa_decode_attention: ks/vs go with an int8 cache and only with it")
    tensors = [q, k, v] + ([ks, vs] if quant else [])
    for x in tensors:
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("gqa_decode_attention: operands must be contiguous and on one device")
    if quant:
        if tuple(ks.shape) != (L, B, NKV, T) or tuple(vs.shape) != (L, B, NKV, T) \
                or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16:
            raise ValueError("gqa_decode_attention: ks/vs must be bf16 [L, B, NKV, T]")
    if scale is None:
        scale = D ** -0.5
    start = kv_start.to(device=q.device, dtype=torch.int32).contiguous()
    end = kv_end.to(device=q.device, dtype=torch.int32).contiguous()
    if start.shape != (B,) or end.shape != (B,):
        raise ValueError("gqa_decode_attention: kv bounds must have shape (B,)")

    def layer_ptr(x):  # base address of layer li
        return x.data_ptr() + int(li) * x.stride(0) * x.element_size()

    out = torch.empty((B, NH, D), dtype=torch.bfloat16, device=q.device)
    rc = _lib().decode_attention(
        q.data_ptr(), layer_ptr(k), layer_ptr(v),
        layer_ptr(ks) if quant else None, layer_ptr(vs) if quant else None,
        out.data_ptr(), start.data_ptr(), end.data_ptr(),
        B, NH, NKV, T, D, int(quant), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_build.check(rc, "decode_attention")
    with kernel_build.counter_lock:
        launches += 1
    return out


def verify_bounds(kv_start: torch.Tensor, kv_off: torch.Tensor, S: int, T: int):
    """(start, end0) as the JAX wrapper clamps them: ``start = clip(kv_start,
    0, T)``, ``end0 = clip(kv_off + 1, 0, T − (S − 1))``, so that query j's
    end ``end0 + j`` stays within the cache."""
    start = kv_start.long().clamp(0, T)
    end0 = (kv_off.long() + 1).clamp(0, T - (S - 1))
    return start, end0


def gqa_block_verify_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, li: int,
    kv_start: torch.Tensor, kv_off: torch.Tensor,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """q [B, S, NH, D]; k, v [L, B, NKV, T, D]; → [B, S, NH, D] in q.dtype.
    The decode kernel's numerics with an S axis."""
    B, S, NH, D = q.shape
    NKV, T = k.shape[2], k.shape[3]
    G = NH // NKV
    if scale is None:
        scale = D ** -0.5
    start, end0 = verify_bounds(kv_start, kv_off, S, T)
    s = torch.einsum("bskgd,bktd->bkgst", q.reshape(B, S, NKV, G, D).float(), k[li].float())
    if ks is not None:
        s = s * (ks[li].float()[:, :, None, None, :] * scale)
    else:
        s = s * scale
    pos = torch.arange(T, device=q.device)
    end = end0[:, None] + torch.arange(S, device=q.device)[None, :]  # [B, S]
    valid = (pos[None, None, :] >= start[:, None, None]) & (pos[None, None, :] < end[:, :, None])
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if vs is not None:
        p = p * vs[li].float()[:, :, None, None, :]
    pv = torch.einsum("bkgst,bktd->bskgd", p, v[li].float())
    l = l.permute(0, 3, 1, 2, 4)  # [B, NKV, G, S, 1] → [B, S, NKV, G, 1]
    return (pv / l.clamp_min(1e-20)).reshape(B, S, NH, D).to(q.dtype)


def gqa_block_verify_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, li: int,
    kv_start: torch.Tensor, kv_off: torch.Tensor,
    ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """Speculative block-verify attention over the stacked cache: S query
    tokens per row, query j seeing ``[kv_start, kv_off + 1 + j)``.

    CPU tensors take :func:`gqa_block_verify_attention_plain`; CUDA tensors
    launch the ``csrc/decode_attention.cu`` kernel (``verify_kernel``) or
    raise. The kernel takes
    bf16 ``q`` [B, S, NH, D], a contiguous bf16 or int8 cache (int8 with
    bf16 ``ks``/``vs``), D ∈ {64, 128}, S ≤ T and at most
    ``MAX_VERIFY_ROWS`` score rows S · NH / NKV.
    """
    global verify_launches
    if q.device.type == "cpu":
        return gqa_block_verify_attention_plain(q, k, v, li, kv_start, kv_off, ks, vs, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_block_verify_attention: unsupported device {q.device}")
    what = "gqa_block_verify_attention"
    B, S, NH, D = q.shape
    L, Bk, NKV, T, Dk = k.shape
    quant = k.dtype == torch.int8
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D or NH % NKV or not 1 <= S <= T:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in (64, 128) or S * (NH // NKV) > MAX_VERIFY_ROWS:
        raise ValueError(f"{what} kernel takes D in (64, 128) and S * group <= {MAX_VERIFY_ROWS}")
    if not 0 <= int(li) < L:
        raise ValueError(f"{what}: layer {li} outside [0, {L})")
    if q.dtype != torch.bfloat16 or k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype:
        raise ValueError(f"{what} kernel takes bf16 q and a bf16 or int8 cache, got {q.dtype}/{k.dtype}/{v.dtype}")
    if quant != (ks is not None) or quant != (vs is not None):
        raise ValueError(f"{what}: ks/vs go with an int8 cache and only with it")
    for x in [q, k, v] + ([ks, vs] if quant else []):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous and on one device")
    if quant and (tuple(ks.shape) != (L, B, NKV, T) or tuple(vs.shape) != (L, B, NKV, T)
                  or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16):
        raise ValueError(f"{what}: ks/vs must be bf16 [L, B, NKV, T]")
    if scale is None:
        scale = D ** -0.5
    start = kv_start.to(device=q.device, dtype=torch.int32).contiguous()
    off = kv_off.to(device=q.device, dtype=torch.int32).contiguous()
    if start.shape != (B,) or off.shape != (B,):
        raise ValueError(f"{what}: kv_start and kv_off must have shape (B,)")

    def layer_ptr(x):  # base address of layer li
        return x.data_ptr() + int(li) * x.stride(0) * x.element_size()

    out = torch.empty((B, S, NH, D), dtype=torch.bfloat16, device=q.device)
    rc = _lib().block_verify_attention(
        q.data_ptr(), layer_ptr(k), layer_ptr(v),
        layer_ptr(ks) if quant else None, layer_ptr(vs) if quant else None,
        out.data_ptr(), start.data_ptr(), off.data_ptr(),
        B, S, NH, NKV, T, D, int(quant), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_build.check(rc, "block_verify_attention")
    with kernel_build.counter_lock:
        verify_launches += 1
    return out
