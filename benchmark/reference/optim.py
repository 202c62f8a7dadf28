"""The recipes' optimizer in the cells' QLoRA form, plainly: gradient
accumulation as a running mean, clipping by the global norm, AdamW on a
warm-up-then-cosine schedule in two groups, the frozen text layers' updates
dropped.

The moments are stored block-wise in 8 bits (Dettmers
et al., "8-bit Optimizers via Block-wise Quantization"): each leaf
flattened into blocks of 256 with one absmax scale each, ``mu`` signed over
[-127, 127], ``nu`` unsigned over [0, 255]; the update dequantizes them,
steps in float32 and quantizes them again. Parameters are kept in the
configuration's dtype (bfloat16), and so is the update (the step, its
weight decay and its learning rate each rounded to that dtype, as optax
computes updates in the parameters' dtype), added in float32 and rounded
once. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    return torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, BLOCK)


def _signed(b: torch.Tensor):
    """Blocks → (int8 codes in [-127, 127], float32 scales)."""
    s = b.abs().amax(-1, keepdim=True) / 127.0
    return torch.clamp(torch.round(b / s.clamp_min(1e-12)), -127, 127).to(torch.int8), s


def _unsigned(b: torch.Tensor):
    """Non-negative blocks → (codes 0..255 as uint8, float32 scales)."""
    s = b.amax(-1, keepdim=True) / 255.0
    return torch.clamp(torch.round(b / s.clamp_min(1e-12)), 0, 255).to(torch.uint8), s


def lr_at(lr: float, cfg: dict, count: int) -> float:
    """Linear warm-up from 0 over ``warmup_ratio · max_steps`` updates, then
    a cosine to 0 at ``max_steps``."""
    warmup = max(int(cfg["warmup_ratio"] * cfg["max_steps"]), 1)
    decay = max(cfg["max_steps"], warmup + 1) - warmup
    if count < warmup:
        return lr * count / warmup
    t = min(count - warmup, decay)
    return lr * 0.5 * (1 + math.cos(math.pi * t / decay))


def group(name: str) -> str:
    """"proj" (projector and geometry head) or "base" (the LoRA adapters)."""
    return "proj" if name.split("/")[0] in ("projector", "geom") else "base"


class AdamW:
    """8-bit AdamW over ``params`` (name → bfloat16 leaf, updated in place);
    the moments kept as the configuration stores them, int8 codes and a
    float32 scale a block."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor]):
        if cfg["optimizer"] != "adamw8bit":
            raise ValueError(f"the reference follows adamw8bit, not {cfg['optimizer']!r}")
        self.cfg, self.params = cfg, params
        self.acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        self.mu = {n: _signed(_blocks(torch.zeros_like(p))) for n, p in params.items()}
        self.nu = {n: _unsigned(_blocks(torch.zeros_like(p))) for n, p in params.items()}
        self.micro, self.count = 0, 0
        L = cfg["text"]["num_layers"]
        self.keep = torch.ones(L)
        for i in cfg["freeze_text_layers"]:
            if i < L:
                self.keep[i] = 0.0

    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        """One micro step's gradients; True when an update was applied."""
        n = self.micro
        for name, g in grads.items():
            self.acc[name] += (g.float() - self.acc[name]) / (n + 1)
        self.micro = (n + 1) % self.cfg["grad_accum"]
        if self.micro:
            return False
        self._update()
        for a in self.acc.values():
            a.zero_()
        return True

    def _update(self) -> None:
        cfg, c = self.cfg, self.count
        norm = torch.sqrt(sum((a * a).sum() for a in self.acc.values()))
        factor = cfg["gradient_clip"] / norm if norm >= cfg["gradient_clip"] else torch.ones_like(norm)
        bc1, bc2 = 1 - B1 ** (c + 1), 1 - B2 ** (c + 1)
        lrs = {"base": lr_at(cfg["lr"], cfg, c), "proj": lr_at(cfg["proj_lr"], cfg, c)}
        L = cfg["text"]["num_layers"]
        for name, p in self.params.items():
            g = _blocks(self.acc[name] * factor)
            (mq, ms), (nq, ns) = self.mu[name], self.nu[name]
            mu = B1 * (mq.float() * ms) + (1 - B1) * g
            nu = B2 * (nq.float() * ns) + (1 - B2) * g * g
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            self.mu[name], self.nu[name] = _signed(mu), _unsigned(nu)  # stored in 8 bits until the next update
            step = step.reshape(-1)[:p.numel()].reshape(p.shape).to(p.dtype)
            u = (step.float() + cfg["weight_decay"] * p.float()).to(p.dtype)
            u = (-lrs[group(name)] * u.float()).to(p.dtype)
            if name.startswith("text/layers/") and p.ndim >= 1 and p.shape[0] == L:
                u = u * self.keep.to(u.device, u.dtype).reshape((-1,) + (1,) * (p.ndim - 1))
            p.copy_((p.float() + u.float()).to(p.dtype))
        self.count += 1
