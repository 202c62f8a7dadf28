"""Block-wise 8-bit AdamW moments (counterpart of
``vggt_qwen3_tpu/train/adam8bit.py``).

Each moment of a leaf is stored as ``{"q": int8 [n_blocks, BLOCK], "s": f32
[n_blocks, 1]}``: the leaf flattened, zero-padded to a multiple of ``BLOCK``
and cut into blocks with one absmax scale each (Dettmers et al., "8-bit
Optimizers via Block-wise Quantization"). ``mu`` is symmetric
(``q = round(mu / s)`` in [-127, 127], ``s = max|mu| / 127``); ``nu``, never
negative, uses the unsigned range over [0, max] (``s = max nu / 255``, codes
0..255 stored minus 128, so its zero state is all -128). Pad elements
dequantize to 0 and their outputs are sliced off.

The update is the JAX module's in its order: the moments dequantized to f32,
``mu ← b1·mu + (1−b1)·g``, ``nu ← b2·nu + (1−b2)·g·g`` (g in f32; each
sum a fused multiply-add, :func:`fma`, as XLA compiles it), the step
``(mu / bc1) / (√(nu / bc2) + eps)`` cast to the gradient's dtype, then both
moments re-quantized. The bias corrections ``1 − b**count`` are f32 powers of
the f32 count, as in JAX. The expressions are written as the jitted JAX
update computes them: XLA turns the divisions by the constants 127 and 255
into products with their f32 reciprocals, and the step's two divisions into
``mu / (bc1 · (√(nu / bc2) + eps))``; so steps, codes and scales are
bit-identical to JAX's jitted ``adamw8bit``. ``torch.round`` rounds half to even, as
``jnp.round`` does.

Leaves of more than ``chunk_blocks`` blocks go through in chunks of that many
block rows (JAX's ``lax.map``), so the f32 working set stays bounded: blocks
are independent, so a chunked update equals one pass bit for bit.

This was plain XLA in JAX, not a Pallas kernel, and it is plain PyTorch here
(a fused update kernel is later performance work, ROADMAP). The moments
live in ``state["mu"]`` / ``state["nu"]`` (name → the dict above) and are
updated in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

BLOCK = 256
# block rows an update step takes at once: 65536 blocks = 16.7 M elements, so
# every f32 intermediate stays at 64 MB
CHUNK_BLOCKS = 65536

Moment = Dict[str, torch.Tensor]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def n_blocks(numel: int) -> int:
    return -(-numel // BLOCK)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """[...] → [n_blocks, BLOCK], zero-padded."""
    flat = x.reshape(-1)
    pad = n_blocks(flat.numel()) * BLOCK - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def _unblock(b: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return b.reshape(-1)[:n].reshape(shape)


def _codes_signed(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = b.abs().amax(-1, keepdim=True) * _f32(1.0 / 127.0, b)
    q = torch.clamp(torch.round(b / torch.clamp_min(s, 1e-12)), -127, 127)
    return q.to(torch.int8), s


def _codes_unsigned(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = b.amax(-1, keepdim=True) * _f32(1.0 / 255.0, b)
    q = torch.clamp(torch.round(b / torch.clamp_min(s, 1e-12)), 0, 255) - 128
    return q.to(torch.int8), s


def quantize_signed(x: torch.Tensor) -> Moment:
    """f32 [...] → int8 blocks with per-block absmax scales (symmetric)."""
    q, s = _codes_signed(_blocks(x.float()))
    return {"q": q, "s": s}


def dequantize_signed(qs: Moment, shape) -> torch.Tensor:
    return _unblock(qs["q"].float() * qs["s"], shape)


def quantize_unsigned(x: torch.Tensor) -> Moment:
    """Non-negative f32 [...] → int8 blocks storing codes 0..255 minus 128."""
    q, s = _codes_unsigned(_blocks(x.float()))
    return {"q": q, "s": s}


def dequantize_unsigned(qs: Moment, shape) -> torch.Tensor:
    return _unblock((qs["q"].float() + 128.0) * qs["s"], shape)


def zeros(p: torch.Tensor, signed: bool) -> Moment:
    """The zero moment of a leaf: codes 0 (``mu``) or -128 (``nu``), scales 0."""
    nb = n_blocks(p.numel())
    return {"q": torch.full((nb, BLOCK), 0 if signed else -128, dtype=torch.int8, device=p.device),
            "s": torch.zeros((nb, 1), dtype=torch.float32, device=p.device)}


def bias_corrections(count: int, b1: float, b2: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``1 − b1**count`` and ``1 − b2**count``: f32 powers of the f32 count,
    computed on the CPU (the same bits for every device) and moved to ``device``."""
    c = torch.tensor(float(count), dtype=torch.float32)
    return tuple((1 - torch.pow(torch.tensor(b, dtype=torch.float32), c)).to(device) for b in (b1, b2))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once: the compiled JAX update's contraction of
    ``c + a·b`` (XLA's CPU backend fuses the multiply into the add). This is
    ``torch.addcmul``, which the CPU computes as a fused multiply-add and
    whose CUDA body nvcc contracts into one."""
    return torch.addcmul(c, a, b)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's and CUDA's). The CPU's
    vectorised ``torch.sqrt`` is not correctly rounded, in f32 or in f64, so
    there the f64 root rounded to f32 is corrected to the float nearest the
    exact root: against the midpoints between it and its neighbours, whose
    squares f64 holds exactly (no square of such a midpoint is a float, so
    there are no ties)."""
    if x.is_cuda:
        return torch.sqrt(x)
    r = torch.sqrt(x.double()).float()
    xd = x.double()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    r = torch.where(xd > ((r.double() + up.double()) / 2) ** 2, up, r)
    return torch.where(xd < ((r.double() + down.double()) / 2) ** 2, down, r)


def _chunk_update(gb, mq, ms, nq, ns, bc1, bc2, b1, b2, eps):
    """One chunk of block rows: gb [k, BLOCK] in the gradient's dtype; every
    intermediate f32 [k, BLOCK]. Returns (step, mu codes, scales, nu codes, scales)."""
    g32 = gb.float()
    mu = mq.float() * ms
    nu = (nq.float() + 128.0) * ns
    mu = fma(g32, _f32(1.0 - b1, g32), _f32(b1, g32) * mu)
    nu = fma(_f32(1.0 - b2, g32) * g32, g32, _f32(b2, g32) * nu)
    # XLA compiles JAX's (mu / bc1) / (√(nu / bc2) + eps) to one division
    step = (mu / (bc1 * (_sqrt(nu / bc2) + _f32(eps, g32)))).to(gb.dtype)
    mq2, ms2 = _codes_signed(mu)
    nq2, ns2 = _codes_unsigned(nu)
    return step, mq2, ms2, nq2, ns2


def leaf_update(g: torch.Tensor, mu: Moment, nu: Moment, bc1: torch.Tensor, bc2: torch.Tensor, *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                chunk_blocks: int = CHUNK_BLOCKS) -> torch.Tensor:
    """The Adam step of one leaf (its shape, the gradient's dtype); ``mu`` and
    ``nu`` are re-quantized in place, ``chunk_blocks`` block rows at a time."""
    gb = _blocks(g)
    nb = gb.shape[0]
    out = torch.empty_like(gb)
    for c0 in range(0, nb, chunk_blocks):
        c1 = min(c0 + chunk_blocks, nb)
        step, mq, ms, nq, ns = _chunk_update(gb[c0:c1], mu["q"][c0:c1], mu["s"][c0:c1], nu["q"][c0:c1],
                                             nu["s"][c0:c1], bc1, bc2, b1, b2, eps)
        out[c0:c1] = step
        mu["q"][c0:c1], mu["s"][c0:c1], nu["q"][c0:c1], nu["s"][c0:c1] = mq, ms, nq, ns
    return _unblock(out, g.shape)


class ScaleByAdam8bit:
    """``scale_by_adam8bit`` over a flat dict of leaves (name → tensor):
    ``init`` gives ``{"count": 0, "mu": {...}, "nu": {...}}``; ``update``
    returns the steps (name → tensor) and advances the state in place."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, chunk_blocks: int = CHUNK_BLOCKS):
        self.b1, self.b2, self.eps, self.chunk_blocks = b1, b2, eps, chunk_blocks

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0, "mu": {n: zeros(p, True) for n, p in params.items()},
                "nu": {n: zeros(p, False) for n, p in params.items()}}

    def update(self, grads: Dict[str, torch.Tensor], state: dict) -> Dict[str, torch.Tensor]:
        state["count"] += 1
        out = {}
        for name, g in grads.items():
            bc1, bc2 = bias_corrections(state["count"], self.b1, self.b2, g.device)
            out[name] = leaf_update(g, state["mu"][name], state["nu"][name], bc1, bc2, b1=self.b1, b2=self.b2,
                                    eps=self.eps, chunk_blocks=self.chunk_blocks)
        return out


class AdamW8bit(ScaleByAdam8bit):
    """``adamw8bit``: the 8-bit Adam step, plus ``weight_decay·p`` when the
    decay is not 0, times ``−learning_rate`` (a float, or a schedule of the
    update count giving an f32 scalar); each in the leaf's dtype, as optax's
    ``add_decayed_weights`` and ``scale_by_learning_rate`` compute them.
    ``update`` returns the updates to add to the params."""

    def __init__(self, learning_rate: Union[float, Callable[[int], torch.Tensor]], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0, chunk_blocks: int = CHUNK_BLOCKS):
        super().__init__(b1, b2, eps, chunk_blocks)
        self.learning_rate, self.weight_decay = learning_rate, weight_decay

    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        count = state["count"]  # the schedule sees the count before this update
        steps = super().update(grads, state)
        sched = self.learning_rate(count) if callable(self.learning_rate) else None
        out = {}
        for name, u in steps.items():
            if self.weight_decay:
                p = params[name]
                u = fma(p, torch.tensor(self.weight_decay, dtype=p.dtype, device=p.device), u)
            lr = (torch.tensor(-self.learning_rate, dtype=u.dtype) if sched is None else -sched).to(u.device, u.dtype)
            out[name] = lr * u
        return out


def scale_by_adam8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      chunk_blocks: int = CHUNK_BLOCKS) -> ScaleByAdam8bit:
    return ScaleByAdam8bit(b1, b2, eps, chunk_blocks)


def adamw8bit(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
              chunk_blocks: int = CHUNK_BLOCKS) -> AdamW8bit:
    """AdamW with 8-bit moments (the JAX module's signature subset, no mask)."""
    return AdamW8bit(learning_rate, b1, b2, eps, weight_decay, chunk_blocks)
