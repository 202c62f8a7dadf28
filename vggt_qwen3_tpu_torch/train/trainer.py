"""SFT trainer (counterpart of ``vggt_qwen3_tpu/train/trainer.py``): the train
state, two-group AdamW with a warmup-cosine schedule, gradient accumulation,
global-norm clipping, frozen-vision and frozen-layer masking.

optax's arithmetic is re-implemented in plain torch, in its order, because
``torch.optim.AdamW`` orders its operations differently. The chain is the
JAX trainer's (``trainer.py:113-159``):

1. ``optax.MultiSteps`` (``grad_accum`` > 1): each micro step's gradient
   enters the running mean ``acc + (g − acc)/(n + 1)`` in the parameter
   dtype; every ``grad_accum``-th micro step the inner chain runs on the mean
   and the accumulators go back to 0, and the other micro steps change no
   parameter. The inner schedules count updates, not micro steps.
2. ``clip_by_global_norm(gradient_clip)`` over **all** leaves — including
   the gradients of the frozen Qwen3 base weights under LoRA, as the JAX
   trainer differentiates every leaf (its clip and its reported
   ``grad_norm`` cover them; the reference's DeepSpeed clip does not).
3. AdamW per group (optax 0.2.6 ``scale_by_adam``: ``mu ← (1−b1)·g + b1·mu``,
   ``nu ← (1−b2)·g² + b2·nu`` in the parameter dtype, bias corrections
   ``1 − b**count`` in f32 cast to that dtype, ``mu_hat / (√nu_hat + eps)``;
   then ``+ weight_decay·p``; then ``× −lr(count)`` cast to the dtype):
   ``base`` (Qwen3, or its LoRA adapters under LoRA; the vision tower when
   not frozen) at ``lr``, ``proj`` (projector and geom head) at ``proj_lr``;
   ``frozen`` leaves get no update and no moments.
4. The frozen-layer mask: updates of ``text/layers`` leaves at the indices of
   ``freeze_text_layers`` times 0.

Python scalars enter the arithmetic as JAX's weakly typed scalars do: cast
to the leaf's dtype first. The step updates the state **in place** (the JAX
step donates and returns it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import StageConfig, TrainConfig
from ..models import qwen3, vlm

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainState:
    params: Any
    opt_state: Dict[str, Any]
    step: int


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(``"a/b/c"`` path, tensor) for every leaf of a nested dict, in order."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from named_leaves(v, name + "/")
        else:
            yield name, v


def cosine_schedule(lr: float, cfg: TrainConfig) -> Callable[[int], torch.Tensor]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(max_steps,
    warmup + 1), 0)`` with ``warmup = max(int(warmup_ratio·max_steps), 1)``,
    as the JAX trainer calls it: an f32 scalar for an int count, each step of
    optax's float32 arithmetic in its order."""
    warmup = max(int(cfg.warmup_ratio * cfg.max_steps), 1)
    decay = max(cfg.max_steps, warmup + 1) - warmup

    def schedule(count: int) -> torch.Tensor:
        c = torch.tensor(count, dtype=torch.int32)
        if count < warmup:  # linear_schedule(0 → lr over warmup)
            frac = 1 - c.clamp(0, warmup) / warmup
            return (0.0 - lr) * frac + lr
        t = torch.clamp_max((c - warmup).float(), float(decay))  # cosine_decay_schedule(lr, decay, alpha=0)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / float(decay)))
        return lr * ((1 - 0.0) * cosine + 0.0)

    return schedule


def param_group_labels(params, freeze_vision: bool, *, lora: bool = False) -> Dict[str, str]:
    """Leaf path → ``"base"`` (Qwen3), ``"proj"`` (projector and geom head)
    or ``"frozen"`` (the vision tower under ``freeze_vision``; with ``lora``
    the text model's base weights, whose adapters take ``"base"``)."""

    def label(name: str) -> str:
        keys = name.split("/")
        if keys[0] in ("projector", "geom"):
            return "proj"
        if keys[0] == "vision":
            return "frozen" if freeze_vision else "base"
        if keys[0] == "text" and lora:
            return "base" if "lora" in keys else "frozen"
        return "base"

    return {name: label(name) for name, _ in named_leaves(params)}


def freeze_text_layers_mask(frozen: tuple, num_layers: int) -> Optional[np.ndarray]:
    """[num_layers] keep factors (0 at the frozen indices that exist), or
    None when nothing is frozen."""
    if not frozen or not num_layers:
        return None
    keep = np.ones((num_layers,), np.float32)
    for i in frozen:
        if i < num_layers:  # configs may freeze [0..3] while --tiny has 2 layers
            keep[i] = 0.0
    return keep


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar in ``like``'s dtype and device (a weak JAX scalar)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def global_norm(grads) -> torch.Tensor:
    """``optax.global_norm``: √(Σ over leaves of Σ x·x), each leaf's squares
    in its dtype and its sum returned in its dtype (summed in f32), the leaf
    sums added in order; leaves without a gradient (None) count 0."""
    total = 0
    for g in grads:
        if g is not None:
            total = total + (g * g).sum(dtype=torch.float32).to(g.dtype)
    if isinstance(total, int):
        return torch.zeros(())
    return torch.sqrt(total)


class Optimizer:
    """The JAX trainer's optax chain (module note) over a nested dict of
    tensors. ``init`` builds the state; ``update`` takes one micro step's
    gradients (name → tensor or None) and changes params and state in place."""

    def __init__(self, cfg: TrainConfig, labels: Dict[str, str], *, freeze_text_layers: tuple = (),
                 num_text_layers: int = 0):
        if cfg.optimizer == "adamw8bit":
            raise NotImplementedError(
                "optimizer adamw8bit (block-wise int8 moments) is not ported yet (ROADMAP: training)")
        if cfg.optimizer != "adamw":
            raise ValueError(f"unknown train.optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.labels = labels
        self.schedules = {"base": cosine_schedule(cfg.lr, cfg),
                          "proj": cosine_schedule(cfg.proj_lr if cfg.proj_lr is not None else cfg.lr, cfg)}
        self.keep = freeze_text_layers_mask(freeze_text_layers, num_text_layers)
        self.num_text_layers = num_text_layers

    def init(self, params) -> Dict[str, Any]:
        """Moments (zeros in the parameter dtype) for every trainable leaf;
        accumulators appear with the first gradient of a leaf."""
        trainable = [(n, p) for n, p in named_leaves(params) if self.labels[n] != "frozen"]
        return {
            "mini_step": 0,
            "gradient_step": 0,
            "acc": {},
            "mu": {n: torch.zeros_like(p) for n, p in trainable},
            "nu": {n: torch.zeros_like(p) for n, p in trainable},
        }

    @torch.no_grad()
    def update(self, grads: Dict[str, Optional[torch.Tensor]], state: Dict[str, Any], params) -> bool:
        """One micro step; True when it emitted an update. Runs in a profiler
        range named "optimizer", which a trace credits its kernels to."""
        with torch.profiler.record_function("optimizer"):
            return self._micro_step(grads, state, params)

    def _micro_step(self, grads: Dict[str, Optional[torch.Tensor]], state: Dict[str, Any], params) -> bool:
        k = self.cfg.grad_accum
        if k <= 1:  # no MultiSteps wrapper: the gradients go straight in
            self._apply(grads, state, params)
            state["gradient_step"] += 1
            return True
        n, acc = state["mini_step"], state["acc"]
        for name, p in named_leaves(params):
            g, a = grads.get(name), acc.get(name)
            if g is None and a is None:
                continue
            if a is None:
                a = acc[name] = torch.zeros_like(p)
            if g is None:
                g = torch.zeros_like(a)
            d = g - a
            d.div_(n + 1)
            a.add_(d)
        emit = n == k - 1
        state["mini_step"] = (n + 1) % k
        if emit:
            self._apply(acc, state, params)
            state["gradient_step"] += 1
            for a in acc.values():
                a.zero_()
        return emit

    def _apply(self, grads: Dict[str, Optional[torch.Tensor]], state: Dict[str, Any], params) -> None:
        cfg = self.cfg
        g_norm = global_norm(grads.get(name) for name, _ in named_leaves(params))
        clip = not bool(g_norm < cfg.gradient_clip)
        count = state["gradient_step"]
        lr = {group: -sched(count) for group, sched in self.schedules.items()}
        bc1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32), float(count + 1))
        bc2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32), float(count + 1))
        for name, p in named_leaves(params):
            group = self.labels[name]
            if group == "frozen":
                continue
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g
            if clip:
                g = (g / g_norm.to(device=g.device, dtype=g.dtype)) * _scalar(cfg.gradient_clip, g)
            mu, nu = state["mu"][name], state["nu"][name]
            mu.mul_(_scalar(B1, mu)).add_(_scalar(1 - B1, g) * g)
            nu.mul_(_scalar(B2, nu)).add_(_scalar(1 - B2, g) * (g * g))
            mu_hat = mu / bc1.to(device=mu.device, dtype=mu.dtype)
            nu_hat = nu / bc2.to(device=nu.device, dtype=nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + _scalar(EPS, nu_hat))
            u = u + _scalar(cfg.weight_decay, p) * p
            u = lr[group].to(device=u.device, dtype=u.dtype) * u
            if self.keep is not None and name.startswith("text/layers/") and u.ndim >= 1 \
                    and u.shape[0] == self.num_text_layers:
                u = u * torch.from_numpy(self.keep).to(device=u.device, dtype=u.dtype).reshape(
                    (-1,) + (1,) * (u.ndim - 1))
            p.add_(u)


def make_tx(stage: StageConfig, params) -> Optimizer:
    """The optimizer of a stage config (labels from the tree's paths)."""
    labels = param_group_labels(params, stage.model.freeze_vision, lora=stage.lora.enable)
    return Optimizer(stage.train, labels, freeze_text_layers=stage.freeze_text_layers,
                     num_text_layers=stage.model.text.num_layers)


def init_train_state(gen: torch.Generator, stage: StageConfig, *, dtype: Optional[str] = None
                     ) -> Tuple[TrainState, Optimizer]:
    """Random params on ``gen.device`` (with LoRA adapters when the stage
    enables them), the optimizer and its zero state, step 0."""
    params = vlm.init_params(gen, stage.model, dtype=dtype)
    if stage.lora.enable:
        params["text"] = qwen3.add_lora(params["text"], stage.model.text, stage.lora, gen)
    tx = make_tx(stage, params)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one micro step, a pure function of
    ``(seed, step)`` — a resumed run draws the masks an uninterrupted run
    draws (JAX folds the step into ``PRNGKey(seed)`` the same way)."""
    state = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def make_train_step(stage: StageConfig, tx: Optimizer, image_token_id: int, *, has_geom: bool):
    """(state, batch, generator) → (state, metrics). The batch holds tensors
    on the params' device (``pixel_values``, ``input_ids``,
    ``attention_mask``, ``labels`` and, with ``has_geom``, the ``geom_token``
    dict); ``generator`` drives the Perceiver's dropout (None: eval mode).
    Every leaf is differentiated, as in JAX; the metrics are the loss and the
    global norm of this micro step's gradients."""
    mcfg = stage.model

    def step_fn(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        leaves = dict(named_leaves(state.params))
        for p in leaves.values():
            p.requires_grad_(True)
            p.grad = None
        try:
            loss = vlm.train_forward(
                state.params, mcfg,
                images=batch["pixel_values"],
                geom_token=batch.get("geom_token") if has_geom else None,
                input_ids=batch["input_ids"],
                attention_mask=batch["attention_mask"],
                labels=batch["labels"],
                image_token_id=image_token_id,
                generator=generator,
            )
            loss.backward()
            grads = {name: p.grad for name, p in leaves.items()}
        finally:
            for p in leaves.values():
                p.grad = None
                p.requires_grad_(False)
        grad_norm = global_norm(grads.values())
        tx.update(grads, state.opt_state, state.params)
        del grads
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step_fn
