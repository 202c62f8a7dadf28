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
   With ``optimizer: adamw8bit`` step 3 is the JAX trainer's chain
   ``scale_by_adam8bit`` (``train/adam8bit.py``: int8 block moments, f32 math,
   the step in the parameter dtype), then ``+ weight_decay·p`` (a fused
   multiply-add, as XLA compiles it), then ``× −lr(count)``.
4. The frozen-layer mask: updates of ``text/layers`` leaves at the indices of
   ``freeze_text_layers`` times 0.

Python scalars enter the arithmetic as JAX's weakly typed scalars do: cast
to the leaf's dtype first. The step updates the state **in place** (the JAX
step donates and returns it).

Sharded state (``state_shardings`` on a mesh of ``parallel/mesh.py``, passed
to :func:`make_train_step`): the params and every optimizer leaf that
mirrors a parameter are DTensors laid out by the registry, the text layers
stage-sharded over ``pp``; the 8-bit moments and the counters replicate, as
in JAX. The step runs on this rank's rows with the weights gathered on use;
the gradients come back to each leaf's layout (reduce-scattered or
all-reduced over the data axes), and clip, the global norm (over the full
gradients) and AdamW / 8-bit AdamW run on each rank's shards — the 8-bit
update on the whole leaf, whose replicated moments it reads, of which each
rank keeps its part. On a mesh of one rank every collective is skipped and
the step is the unmeshed step's arithmetic, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from ..config import StageConfig, TrainConfig
from ..models import qwen3, vlm
from ..models.common import leaf_hook
from ..parallel.mesh import DATA_AXES, axis_group, mesh_shape
from ..parallel.sharding import (NamedSharding, empty_shard, gather_local, keep_shard, local, local_part,
                                 param_specs, path_keys, place, sharded_dims, spec_with_pp)
from . import adam8bit

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
    sums added in order; leaves without a gradient (None) count 0. A
    DTensor leaf's f32 sum is its shards' sums all-reduced over the mesh
    dims it is sharded on (one all-reduce for the leaves of each layout)."""
    leaves = [g for g in grads if g is not None]
    sums = [(local(g) * local(g)).sum(dtype=torch.float32) for g in leaves]
    by_layout = {}
    for i, g in enumerate(leaves):
        dims = sharded_dims(g)
        if dims:
            by_layout.setdefault((g.device_mesh, dims), []).append(i)
    for (mesh, dims), idx in by_layout.items():
        both = torch.stack([sums[i] for i in idx])
        for d in dims:
            dist.all_reduce(both, group=mesh.get_group(d))
        for j, i in enumerate(idx):
            sums[i] = both[j]
    total = 0
    for g, s in zip(leaves, sums):
        total = total + s.to(g.dtype)
    if isinstance(total, int):
        return torch.zeros(())
    return torch.sqrt(total)


class Optimizer:
    """The JAX trainer's optax chain (module note) over a nested dict of
    tensors. ``init`` builds the state; ``update`` takes one micro step's
    gradients (name → tensor or None) and changes params and state in place."""

    def __init__(self, cfg: TrainConfig, labels: Dict[str, str], *, freeze_text_layers: tuple = (),
                 num_text_layers: int = 0):
        if cfg.optimizer not in ("adamw", "adamw8bit"):
            raise ValueError(f"unknown train.optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.labels = labels
        self.schedules = {"base": cosine_schedule(cfg.lr, cfg),
                          "proj": cosine_schedule(cfg.proj_lr if cfg.proj_lr is not None else cfg.lr, cfg)}
        self.keep = freeze_text_layers_mask(freeze_text_layers, num_text_layers)
        self.num_text_layers = num_text_layers

    def init(self, params) -> Dict[str, Any]:
        """Moments for every trainable leaf (zeros in the parameter dtype; for
        ``adamw8bit`` the zero int8 blocks of ``adam8bit.zeros``); accumulators
        appear with the first gradient of a leaf."""
        trainable = [(n, p) for n, p in named_leaves(params) if self.labels[n] != "frozen"]
        if self.cfg.optimizer == "adamw8bit":
            mu = {n: adam8bit.zeros(p, True) for n, p in trainable}
            nu = {n: adam8bit.zeros(p, False) for n, p in trainable}
        else:
            mu = {n: torch.zeros_like(p) for n, p in trainable}
            nu = {n: torch.zeros_like(p) for n, p in trainable}
        return {"mini_step": 0, "gradient_step": 0, "acc": {}, "mu": mu, "nu": nu}

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
            a = local(a)
            g = torch.zeros_like(a) if g is None else local(g)
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
        bc8 = None
        for name, p in named_leaves(params):
            group = self.labels[name]
            if group == "frozen":
                continue
            g = grads.get(name)
            g = torch.zeros_like(local(p)) if g is None else local(g)
            if clip:
                g = (g / g_norm.to(device=g.device, dtype=g.dtype)) * _scalar(cfg.gradient_clip, g)
            mu, nu = state["mu"][name], state["nu"][name]
            if cfg.optimizer == "adamw8bit":  # JAX: scale_by_adam8bit, add_decayed_weights, scale_by_learning_rate
                if bc8 is None:
                    bc8 = adam8bit.bias_corrections(count + 1, B1, B2, p.device)
                # the replicated block moments cover the whole leaf: update it whole, keep this rank's part
                whole = _gathered(p)
                u = adam8bit.leaf_update(_gathered(p, g), mu, nu, *bc8, b1=B1, b2=B2, eps=EPS)
                u = adam8bit.fma(whole, _scalar(cfg.weight_decay, whole), u)
            else:
                mu, nu, pl = local(mu), local(nu), local(p)
                mu.mul_(_scalar(B1, mu)).add_(_scalar(1 - B1, g) * g)
                nu.mul_(_scalar(B2, nu)).add_(_scalar(1 - B2, g) * (g * g))
                mu_hat = mu / bc1.to(device=mu.device, dtype=mu.dtype)
                nu_hat = nu / bc2.to(device=nu.device, dtype=nu.dtype)
                u = mu_hat / (torch.sqrt(nu_hat) + _scalar(EPS, nu_hat))
                u = u + _scalar(cfg.weight_decay, pl) * pl
            u = lr[group].to(device=u.device, dtype=u.dtype) * u
            if self.keep is not None and name.startswith("text/layers/") and u.ndim >= 1 \
                    and p.shape[0] == self.num_text_layers:
                keep = torch.from_numpy(self.keep).to(device=u.device, dtype=u.dtype).reshape(
                    (-1,) + (1,) * (u.ndim - 1))
                u = u * (keep if u.shape[0] == self.num_text_layers else local_part(keep, p, dims=(0,)))
            if cfg.optimizer == "adamw8bit":
                u = local_part(u, p)
            local(p).add_(u)


def _gathered(p, value=None) -> torch.Tensor:
    """The whole of a leaf laid out as the DTensor ``p`` (``value``: a
    tensor with ``p``'s layout, else ``p`` itself); a plain tensor as it is."""
    value = p if value is None else value
    if not isinstance(p, DTensor):
        return value
    return gather_local(local(value), p.device_mesh, p.placements)


def make_tx(stage: StageConfig, params) -> Optimizer:
    """The optimizer of a stage config (labels from the tree's paths)."""
    labels = param_group_labels(params, stage.model.freeze_vision, lora=stage.lora.enable)
    return Optimizer(stage.train, labels, freeze_text_layers=stage.freeze_text_layers,
                     num_text_layers=stage.model.text.num_layers)


def init_train_state(gen: torch.Generator, stage: StageConfig, *, dtype: Optional[str] = None, mesh=None
                     ) -> Tuple[TrainState, Optimizer]:
    """Random params on ``gen.device`` (with LoRA adapters when the stage
    enables them), the optimizer and its zero state, step 0.

    With ``mesh`` the state is made straight into its shardings
    (:func:`state_shardings` on ``mesh``; JAX's ``jit(init_fn,
    out_shardings=...)``): every rank draws each leaf in turn from ``gen``
    (the same seed on every rank), keeps its own shard and frees the whole
    before the next leaf is drawn, so no rank holds more than one whole leaf
    beside its shards; the moments are zeros of the local shards' shapes
    (the 8-bit block moments replicate, as the registry lays them out). The
    values are those of the unsharded init with the same generator."""
    if mesh is None:
        params = vlm.init_params(gen, stage.model, dtype=dtype)
        if stage.lora.enable:
            params["text"] = qwen3.add_lora(params["text"], stage.model.text, stage.lora, gen)
        tx = make_tx(stage, params)
        return TrainState(params=params, opt_state=tx.init(params), step=0), tx
    abstract, order = abstract_train_state(stage, dtype=dtype)
    shardings = dict(named_leaves(state_shardings(abstract, mesh).params))
    names = iter(order)

    def keep(x):
        name = next(names)
        return keep_shard(x, shardings[name], name)

    with leaf_hook(keep):
        return init_train_state(gen, stage, dtype=dtype)


def abstract_train_state(stage: StageConfig, *, dtype: Optional[str] = None) -> Tuple[TrainState, List[str]]:
    """The train state's structure without values, as ``jax.eval_shape`` of
    JAX's init gives it: :func:`init_train_state` traced under
    ``FakeTensorMode`` (no value drawn or stored; the generator does not
    move) → (the state with a meta tensor of each leaf's shape and dtype,
    the parameters' names in the order the init makes them).
    :func:`state_shardings` lays it out; :func:`allocate_state` makes its
    storage."""
    made = []
    with FakeTensorMode(), leaf_hook(lambda x: made.append(x) or x):
        state, _ = init_train_state(torch.Generator(), stage, dtype=dtype)
    names = {id(p): n for n, p in named_leaves(state.params)}
    order = [names[id(x)] for x in made]
    if sorted(order) != sorted(names.values()):  # a leaf made outside the hook, or passed twice
        raise RuntimeError("init_params made leaves that did not pass its leaf hook once each")
    return _map_tensors(state, lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")), order


def allocate_state(abstract: TrainState, device, mesh=None) -> TrainState:
    """Uninitialised storage for an abstract state (meta or any tensors give
    the shapes and dtypes) on ``device``: whole tensors without ``mesh``;
    with it, each rank's own shard of every leaf the registry lays out
    (:func:`state_shardings`) and the replicated 8-bit moments whole, as
    :func:`shard_state` lays a state out. Counterpart of JAX's
    ``abstract_like`` with shardings, the target a restore reads into."""
    if mesh is None:
        return _map_tensors(abstract, lambda x: torch.empty(x.shape, dtype=x.dtype, device=device))
    sh = state_shardings(abstract, mesh)

    def alloc(tree, shardings, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = alloc(v, shardings[k], f"{prefix}{k}/")
            elif isinstance(v, torch.Tensor):
                out[k] = empty_shard(v.shape, v.dtype, shardings[k], device, prefix + k)
            else:
                out[k] = v
        return out

    whole = lambda x: torch.empty(x.shape, dtype=x.dtype, device=device)  # noqa: E731
    opt = {}
    for key, v in abstract.opt_state.items():
        if key in ("mu", "nu", "acc"):  # the 8-bit moments' dicts replicate: whole on every rank
            opt[key] = {n: (_map_tensors(m, whole) if isinstance(m, dict) else
                            empty_shard(m.shape, m.dtype, sh.opt_state[key][n], device, f"{key}/{n}"))
                        for n, m in v.items()}
        else:
            opt[key] = v
    return TrainState(params=alloc(abstract.params, sh.params), opt_state=opt, step=abstract.step)


def _map_tensors(tree, fn):
    """``tree`` (a nested dict, a :class:`TrainState` or a leaf) with every tensor leaf through ``fn``."""
    if isinstance(tree, TrainState):
        return TrainState(params=_map_tensors(tree.params, fn), opt_state=_map_tensors(tree.opt_state, fn),
                          step=tree.step)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one micro step, a pure function of
    ``(seed, step)`` — a resumed run draws the masks an uninterrupted run
    draws (JAX folds the step into ``PRNGKey(seed)`` the same way)."""
    state = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def state_specs(state: TrainState, pp: int = 1) -> TrainState:
    """The registry's spec of every leaf of a train state (JAX's
    ``state_shardings`` rules): the params by their paths; each optimizer
    leaf that mirrors a parameter (``mu``, ``nu``, the accumulators ``acc``,
    given for every parameter since they appear with its first gradient)
    by its parameter's path, the text layers stage-sharded over ``pp``; the
    8-bit block moments and the counters replicate."""
    params = param_specs(state.params, pp)
    mirror = {n: spec_with_pp(path_keys(n), p.ndim, pp) for n, p in named_leaves(state.params)}

    def moments(tree):
        return {n: ({k: () for k in m} if isinstance(m, dict) else mirror[n]) for n, m in tree.items()}

    opt = {k: (moments(v) if k in ("mu", "nu") else dict(mirror) if k == "acc" else ())
           for k, v in state.opt_state.items()}
    return TrainState(params=params, opt_state=opt, step=())


def state_shardings(state: TrainState, mesh) -> TrainState:
    """:func:`state_specs` as :class:`~..parallel.sharding.NamedSharding` s on ``mesh``."""
    pp = mesh_shape(mesh).get("pp", 1)
    specs = state_specs(state, pp)

    def on_mesh(tree):
        if isinstance(tree, dict):
            return {k: on_mesh(v) for k, v in tree.items()}
        return NamedSharding(mesh, tree)

    return TrainState(params=on_mesh(specs.params), opt_state=on_mesh(specs.opt_state), step=on_mesh(specs.step))


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """Lay the state's tensors out by ``shardings`` in place (plain tensors
    become DTensors; leaves already so laid out stay as they are). Every
    rank holds the same full state before; rank 0's is distributed."""

    def put(tree, sh, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(v, sh[k], f"{prefix}{k}/")
            elif isinstance(v, torch.Tensor):
                tree[k] = place(v, sh[k], prefix + k)

    put(state.params, shardings.params)
    opt = state.opt_state
    for key in ("mu", "nu", "acc"):
        for name, v in opt[key].items():
            if isinstance(v, torch.Tensor):  # the 8-bit moments' dicts replicate: plain tensors on every rank
                opt[key][name] = place(v, shardings.opt_state[key][name], f"{key}/{name}")
    return state


def make_train_step(stage: StageConfig, tx: Optimizer, image_token_id: int, *, has_geom: bool,
                    state_sharding: Optional[TrainState] = None, ring_axis: Optional[str] = None):
    """(state, batch, generator) → (state, metrics). The batch holds tensors
    on the params' device (``pixel_values``, ``input_ids``,
    ``attention_mask``, ``labels`` and, with ``has_geom``, the ``geom_token``
    dict); ``generator`` drives the Perceiver's dropout (None: eval mode).
    Every leaf is differentiated, as in JAX; the metrics are the loss and the
    global norm of this micro step's gradients.

    ``state_sharding`` (:func:`state_shardings`): the state is laid out by it
    (at the first call, where it is not yet) and the batch is this rank's
    rows of the global batch (``parallel.sharding.shard_batch``: every rank
    of a ``dp × fsdp`` block holds the same rows); the loss and metrics are
    the global batch's. With ``pp > 1`` the text stack runs as a GPipe
    pipeline of ``pp_microbatches`` (default ``2·pp``) microbatches.
    ``ring_axis`` (needs ``state_sharding``): VGGT's global attention as ring
    attention over that mesh axis (``--ring`` in the sft CLI)."""
    mcfg = stage.model
    if ring_axis is not None and state_sharding is None:
        raise ValueError("ring_axis requires state_sharding (a mesh to ring over)")
    parallel = {}
    if state_sharding is not None:
        mesh = next(named_leaves(state_sharding.params))[1].mesh
        shape = mesh_shape(mesh)
        if ring_axis is not None:
            if shape.get(ring_axis, 1) < 2:
                raise ValueError(f"ring axis {ring_axis!r} has extent < 2 on mesh {shape}")
            parallel.update(ring_group=mesh.get_group(ring_axis), ring_rows_sharded=ring_axis in DATA_AXES)
        if shape.get("pp", 1) > 1:
            from ..parallel.pipeline import PipelinePlan

            parallel["pipeline"] = PipelinePlan(mesh, stage.train.pp_microbatches or 2 * shape["pp"])
        parallel["data_group"] = axis_group(mesh, DATA_AXES)

    def step_fn(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        if state_sharding is not None:
            shard_state(state, state_sharding)
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
                **parallel,
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
