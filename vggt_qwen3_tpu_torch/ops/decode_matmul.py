"""W8 dequant-matmul kernels of the decode step: the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``vggt_qwen3_tpu/ops/decode_matmul.py`` (the Pallas
``_qkv_kernel``, ``_linear_kernel``, ``_mlp_kernel`` and
``_head_argmax_kernel``). Same names and arguments: the layer wrappers take
the **stacked** ``{"w8": [L, K, N] int8, "scale": [L, 1, N] bf16}`` weights
and a layer index, and the kernel reads layer ``li`` by pointer offset, so no
per-layer copy is made. The head takes the tied embedding's row quantization
``{"w8": [V, H] int8, "scale": [V, 1] bf16}``.

Numerics (kernels and plain versions alike): the dequantized weight is
``w8.to(x.dtype) * scale.to(x.dtype)`` rounded to the activation dtype, the
products are summed in f32 and each projection's output is rounded to the
activation dtype; the MLP's activation is ``silu(g) * u`` over the rounded
projections. The head does not scale before the dot: f32 logits are
``x · w8ᵀ``, then × the f32 scale; ties go to the lowest vocab index.

The plain versions are built from :func:`ops.quant.linear`, as the JAX
oracle ``mlp_w8_xla`` is. CPU tensors take them; CUDA tensors launch the
``csrc/decode_matmul.cu`` kernels or raise. The TPU gates (``mlp_eligible``,
``qkv_eligible``, ``linear_eligible``, ``head_argmax_eligible``: batch size
and VMEM tiling) are not carried over: the kernels take any number of rows
and raise on a K that is not a multiple of 64 or an N that is not a multiple
of 128. How ``w8_gemm`` (QKV, WO, the MLP's down projection) cuts a launch,
and so orders its sums, is the kernel's own choice and depends on (M, K)
only (``w8_gemm_plan`` in ``csrc/decode_matmul.cu`` returns it).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import kernel_build, quant

# Incremented once per wrapper call that launches its kernel (never for the
# plain version). fused_mlp_w8 and fused_head_argmax launch two kernels a call
# and count one.
launches: Dict[str, int] = {
    "fused_qkv_w8": 0, "fused_linear_w8": 0, "fused_mlp_w8": 0, "fused_head_argmax": 0,
}

K_TILE = 64    # the kernels' depth step: K must be a multiple
N_TILE = 128   # the layer GEMM's and the head's column tile: N (and V) must be a multiple
MLP_N_TILE = 64


def _at(w: Dict[str, torch.Tensor], li: int) -> Dict[str, torch.Tensor]:
    return {"w8": w["w8"][li], "scale": w["scale"][li]}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_linear_w8_plain(x: torch.Tensor, w: dict, li: int) -> torch.Tensor:
    return quant.linear(x, _at(w, li))


def fused_qkv_w8_plain(x: torch.Tensor, wq: dict, wk: dict, wv: dict, li: int):
    return tuple(quant.linear(x, _at(w, li)) for w in (wq, wk, wv))


def fused_mlp_w8_plain(x: torch.Tensor, gate: dict, up: dict, down: dict, li: int) -> torch.Tensor:
    a = F.silu(quant.linear(x, _at(gate, li))) * quant.linear(x, _at(up, li))
    return quant.linear(a, _at(down, li))


def head_logits(x: torch.Tensor, head: dict) -> torch.Tensor:
    """f32 ``(x · w8ᵀ) × scale`` [B, V]: the int8 values enter the dot
    unscaled (exact products of x with integers), the per-row scale
    multiplies the f32 result."""
    return (x.float() @ head["w8"].float().t()) * head["scale"][:, 0].float()


def fused_head_argmax_plain(x: torch.Tensor, head: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = head_logits(x, head)
    tok = torch.argmax(logits, dim=-1)  # first index among equal maxima
    return tok.to(torch.int32), logits.gather(1, tok[:, None])[:, 0]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _lib():
    lib = kernel_build.load("decode_matmul").lib
    P, I = ctypes.c_void_p, ctypes.c_int
    if lib.w8_gemm.argtypes is None:
        lib.w8_gemm.argtypes = [P, I, I] + [P, P, P, I] * 3 + [I, P]
        lib.w8_gemm.restype = I
        lib.w8_swiglu.argtypes = [P, I, I, P, P, P, P, P, I, P]
        lib.w8_swiglu.restype = I
        lib.head_argmax.argtypes = [P, I, I, P, P, I, P, P, P, P, P]
        lib.head_argmax.restype = I
        lib.w8_gemm_plan.argtypes = [I, I, P]
        lib.w8_gemm_plan.restype = I
    return lib


def _use_kernel(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU tensor (the plain
    version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous() or x.shape[0] < 1:
        raise ValueError(f"{name} kernel takes a contiguous bf16 [M, K] activation, M >= 1; "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] % K_TILE:
        raise ValueError(f"{name} kernel takes K a multiple of {K_TILE}, got {x.shape[1]}")


def _layer_ptrs(name: str, x: torch.Tensor, w: dict, li: int, n_tile: int) -> Tuple[int, int, int]:
    """(weight pointer, scale pointer, N) of layer ``li`` of a stacked W8
    weight, after checking it against ``x``."""
    quant.require_w8(w)
    w8, s = w["w8"], w["scale"]
    if w8.ndim != 3 or w8.dtype != torch.int8 or s.dtype != torch.bfloat16:
        raise ValueError(f"{name}: weights must be stacked int8 [L, K, N] with bf16 scales")
    L, K, N = w8.shape
    if tuple(s.shape) != (L, 1, N) or K != x.shape[1]:
        raise ValueError(f"{name}: w8 {tuple(w8.shape)}, scale {tuple(s.shape)}, x {tuple(x.shape)}")
    if N % n_tile:
        raise ValueError(f"{name} kernel takes N a multiple of {n_tile}, got {N}")
    if not 0 <= int(li) < L:
        raise ValueError(f"{name}: layer {li} outside [0, {L})")
    for t in (w8, s):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous and on {x.device}")
    li = int(li)
    return (w8.data_ptr() + li * w8.stride(0) * w8.element_size(),
            s.data_ptr() + li * s.stride(0) * s.element_size(), N)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _gemm(name: str, x: torch.Tensor, ws, li: int):
    """One ``w8_gemm`` launch over 1–3 stacked weights at layer ``li``."""
    M, K = x.shape
    segs, outs = [], []
    for w in ws:
        wp, sp, N = _layer_ptrs(name, x, w, li, N_TILE)
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        segs += [wp, sp, out.data_ptr(), N]
        outs.append(out)
    segs += [None, None, None, 0] * (3 - len(ws))
    kernel_build.check(_lib().w8_gemm(x.data_ptr(), M, K, *segs, len(ws), _stream(x)), name)
    return outs


def fused_qkv_w8(x: torch.Tensor, wq: dict, wk: dict, wv: dict, li: int):
    """q/k/v = x @ deq(wq/wk/wv)[li] in one launch: the block grid walks the
    concatenated N tiles of wq|wk|wv. x [M, H] → (q [M, NQ], k [M, NKV·D],
    v [M, NKV·D]) in x's dtype."""
    if not _use_kernel("fused_qkv_w8", x):
        return fused_qkv_w8_plain(x, wq, wk, wv, li)
    _check_x("fused_qkv_w8", x)
    out = tuple(_gemm("fused_qkv_w8", x, (wq, wk, wv), li))
    launches["fused_qkv_w8"] += 1
    return out


def fused_linear_w8(x: torch.Tensor, w: dict, li: int) -> torch.Tensor:
    """x [M, K] @ deq(w)[li] → [M, N] (the wo projection's kernel)."""
    if not _use_kernel("fused_linear_w8", x):
        return fused_linear_w8_plain(x, w, li)
    _check_x("fused_linear_w8", x)
    (out,) = _gemm("fused_linear_w8", x, (w,), li)
    launches["fused_linear_w8"] += 1
    return out


def fused_mlp_w8(x: torch.Tensor, gate: dict, up: dict, down: dict, li: int) -> torch.Tensor:
    """SwiGLU MLP ``(silu(x@gate) · (x@up)) @ down`` at layer ``li``, two
    launches: the gate/up dual GEMM writing the activation [M, F], then the
    down GEMM. x [M, H] → [M, H] (the residual add stays with the caller)."""
    name = "fused_mlp_w8"
    if not _use_kernel(name, x):
        return fused_mlp_w8_plain(x, gate, up, down, li)
    _check_x(name, x)
    M, H = x.shape
    gp, gs, Fd = _layer_ptrs(name, x, gate, li, MLP_N_TILE)
    up_p, us, Fu = _layer_ptrs(name, x, up, li, MLP_N_TILE)
    if Fu != Fd or Fd % K_TILE or tuple(down["w8"].shape[1:]) != (Fd, H):
        raise ValueError(f"{name}: gate/up/down shapes {tuple(gate['w8'].shape)} "
                         f"{tuple(up['w8'].shape)} {tuple(down['w8'].shape)}")
    a = torch.empty((M, Fd), dtype=torch.bfloat16, device=x.device)
    kernel_build.check(_lib().w8_swiglu(x.data_ptr(), M, H, gp, gs, up_p, us, a.data_ptr(), Fd, _stream(x)),
                       "fused_mlp_w8 (gate/up)")
    (out,) = _gemm(name, a, (down,), li)
    launches[name] += 1
    return out


def fused_head_argmax(x: torch.Tensor, head: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy LM head over the tied W8 embedding: argmax over V of
    ``(x · w8ᵀ) × scale`` without materialising the [M, V] logits.
    x [M, H] → (tokens [M] int32, max logit [M] f32)."""
    name = "fused_head_argmax"
    if not _use_kernel(name, x):
        return fused_head_argmax_plain(x, head)
    _check_x(name, x)
    quant.require_w8(head)
    w8, s = head["w8"], head["scale"]
    M, H = x.shape
    V = w8.shape[0]
    if w8.dtype != torch.int8 or tuple(w8.shape) != (V, H) or tuple(s.shape) != (V, 1) \
            or s.dtype != torch.bfloat16:
        raise ValueError(f"{name}: head must be int8 [V, {H}] with bf16 [V, 1] scales, "
                         f"got {tuple(w8.shape)} {tuple(s.shape)}")
    if V % N_TILE:
        raise ValueError(f"{name} kernel takes V a multiple of {N_TILE}, got {V}")
    for t in (w8, s):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: head must be contiguous and on {x.device}")
    n_tiles = V // N_TILE
    pval = torch.empty((M, n_tiles), dtype=torch.float32, device=x.device)
    pidx = torch.empty((M, n_tiles), dtype=torch.int32, device=x.device)
    tok = torch.empty((M,), dtype=torch.int32, device=x.device)
    mx = torch.empty((M,), dtype=torch.float32, device=x.device)
    kernel_build.check(_lib().head_argmax(x.data_ptr(), M, H, w8.data_ptr(), s.data_ptr(), V, pval.data_ptr(),
                                          pidx.data_ptr(), tok.data_ptr(), mx.data_ptr(), _stream(x)), name)
    launches[name] += 1
    return tok, mx
