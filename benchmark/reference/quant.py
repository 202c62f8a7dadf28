"""The configurations' quantized formats, worked out again from the dense
weights, and the lower precision of the control.

- W8 (a frozen projection ``[..., K, N]``): one scale an output channel,
  ``max|w| · f32(1/127)`` clamped to 1e-8, codes ``round(w / s)`` in
  [-127, 127], the scale stored in bfloat16 (the format the port and the JAX
  package share). Dequantized here in float32: ``codes · bf16(scale)``.
- W8 rows (the tied embedding ``[V, H]``): one scale a row, the row max
  clamped to 1e-8 before the product with ``f32(1/127)``.
- W8A8: the W8 weight, and each activation row quantized the same way on
  the fly; the int32 product is exact.
- :func:`fp8`: the control's precision, one step below bfloat16: a tensor
  scaled to the float8 range and rounded there (e4m3 forward, e5m2 for the
  gradients, as float8 training recipes run); the control's tower takes its
  activations in int4, the step below int8.
"""

from __future__ import annotations

import torch

INV_127 = 1.0 / 127.0


def _inv127(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(INV_127, dtype=torch.float32, device=x.device)


def w8_channels(w: torch.Tensor) -> dict:
    """[..., K, N] → {"q": int8 codes, "s": bf16 [..., 1, N]}."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(-2, keepdim=True) * _inv127(wf), 1e-8)
    return {"q": torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8), "s": s.to(torch.bfloat16)}


def w8_rows(w: torch.Tensor) -> dict:
    """[V, H] → {"q": int8 codes, "s": bf16 [V, 1]}."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(-1, keepdim=True), 1e-8) * _inv127(wf)
    return {"q": torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8), "s": s.to(torch.bfloat16)}


def dense(w: dict) -> torch.Tensor:
    """A W8 dict as float32."""
    return w["q"].float() * w["s"].float()


def int8_product(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The exact product of two int8 matrices, as float32 (exact while the
    sums stay below 2**24 in magnitude; on the CPU through float64)."""
    if x8.is_cuda and x8.shape[0] > 16:
        return torch._int_mm(x8, w8).float()
    return (x8.double() @ w8.double()).float()


def w8a8_linear(x: torch.Tensor, w: dict, act_bits: int = 8) -> torch.Tensor:
    """x [..., K] float32 through a W8A8 projection: per-row int8
    activations (``act_bits`` 4: int4, the control's), the exact integer
    product, both scales in float32."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    qmax = 2 ** (act_bits - 1) - 1
    inv = _inv127(xf) if act_bits == 8 else torch.tensor(1.0 / qmax, device=xf.device)
    xs = torch.clamp_min(xf.abs().amax(-1, keepdim=True) * inv, 1e-8)
    x8 = torch.clamp(torch.round(xf / xs), -qmax, qmax).to(torch.int8)
    y = int8_product(x8, w["qc"]) * xs * w["s"].reshape(1, -1).float()
    return y.reshape(*lead, -1)


def channel_major(w: dict) -> dict:
    """A 2-D W8 dict with its codes also kept channel-major (``"qc"``), the
    layout the card's int8 GEMM takes fastest."""
    return dict(w, qc=w["q"].t().contiguous().t())


def fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to float8 with one scale for the whole tensor (its largest
    magnitude at the format's largest value), back in float32."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(), 1e-30) / torch.finfo(dtype).max
    return (xf / s).to(dtype).float() * s
