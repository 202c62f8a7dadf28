"""The sharding registry and the gather on use (counterpart of
``vggt_qwen3_tpu/parallel/sharding.py``).

The registry is the JAX module's, rule for rule: column-parallel projections
(QKV, gate/up, the attention qkv) split their output dim over ``tp`` and
their input dim over ``fsdp``; row-parallel ones (attention out, MLP down)
the other way round; embeddings and heads likewise; vectors, norms, LoRA
adapters and the Perceiver latents replicate. Rules match path suffixes, so
they hold for the stacked ``[L, ...]`` layers (the layer dim never shards,
except the text layers' over ``pp`` when ``pp > 1``). A spec is a plain tuple
over the tensor's dims: None, an axis name, or a tuple of axis names.

Storage follows the registry (``torch.distributed.tensor.DTensor``); the
compute runs on weights gathered on use. :func:`full` takes a DTensor leaf
(or a :class:`LayerShard`, one layer of a stacked DTensor leaf) to its full
local tensor through the autograd collectives below, which know the
gradients' layout: each data rank (``dp`` × ``fsdp``) differentiates its own
rows, so a gathered weight's gradient is a partial sum over the data axes
(reduce-scattered back to a ``fsdp`` shard, all-reduced where the leaf
replicates), while every ``tp`` and ``pp`` rank runs the same replicated
compute, so over those axes the gradient is already whole and each rank
keeps its own chunk. Plain tensors pass through untouched. A group of one
rank runs no collective: on one card a gather is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from .mesh import DATA_AXES, axis_index, axis_size, mesh_shape

Spec = Tuple[Any, ...]

# the single-tensor collectives under their newer names where they exist
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------


def _spec_for(path: Tuple[str, ...], ndim: int) -> Spec:
    """The spec of a parameter at ``path`` (tree keys) with ``ndim`` dims."""
    name = path[-1]
    # quantized weights {"w8": [.., K, N], "scale": [.., 1, N]} take their
    # projection's rule (the scale's singleton row never shards)
    if name in ("w8", "scale") and len(path) >= 2:
        if path[-2] == "embed":  # quantized embedding: w8 [V, H], per-row scale [V, 1]
            return ("fsdp", "tp") if name == "w8" else ("fsdp", None)
        parent = _spec_for(path[:-1] + (path[-2],), ndim)
        if name == "scale" and ndim >= 2:
            dims = list(parent) + [None] * (ndim - len(parent))
            dims[-2] = None
            return tuple(dims)
        return parent
    if "lora" in path:  # LoRA adapters are small: replicate
        return ()

    def last2(spec_in, spec_out):
        return (None,) * (ndim - 2) + (spec_in, spec_out)

    if "patch" in path and name == "proj_w" and ndim == 4:  # patch embed [P, P, 3, E]
        return (None, None, None, "tp")
    if name in ("wq", "wk", "wv", "gate", "up", "qkv_w", "mlp_w1", "in_proj_w"):  # column-parallel
        return last2("fsdp", "tp")
    if name in ("wo", "down", "proj_w", "mlp_w2", "out_proj_w"):  # row-parallel
        return last2("tp", "fsdp")
    if name == "embed":  # [V, H]
        return ("fsdp", "tp")
    if name == "lm_head":  # [H, V]
        return ("tp", "fsdp")
    if name == "pos":  # [N, E] vision pos-embed: features shard
        return (None, "tp") if ndim == 2 else ()
    return ()  # latents, norms, biases, LayerScale, tokens


def spec_with_pp(keys: Tuple[str, ...], ndim: int, pp: int) -> Spec:
    """The suffix rule plus, when ``pp > 1``, the text decoder's stacked
    layers (``text`` followed by ``layers`` anywhere in the path, so
    optimizer leaves that mirror them match too) sharded over ``pp`` on
    their layer dim: each pipeline rank stores and updates its own stage."""
    spec = _spec_for(keys, ndim)
    if pp > 1 and ndim >= 1:
        klist = list(keys)
        if "text" in klist:
            i = klist.index("text")
            if i + 1 < len(klist) and klist[i + 1] == "layers":
                dims = list(spec) + [None] * (ndim - len(spec))
                if dims and dims[0] is None:
                    spec = ("pp", *dims[1:])
    return spec


def path_keys(path) -> Tuple[str, ...]:
    """A leaf path (``"a/b/c"``, or a sequence of keys) → a tuple of string keys."""
    if isinstance(path, str):
        return tuple(path.split("/"))
    return tuple(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params: Any, pp: int = 1) -> Any:
    """The spec of every leaf of ``params`` (tensors of any device, meta too)."""
    return _map_with_path(lambda path, x: spec_with_pp(path, x.ndim, pp), params)


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` where
    dim ``d`` of the spec names that axis (alone or in a tuple, as the batch's
    ``("dp", "fsdp")``), ``Replicate()`` elsewhere."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, s in enumerate(spec) if s == name or (isinstance(s, tuple) and name in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as JAX's ``NamedSharding``; ``placements`` is the
    DTensor layout of the spec."""

    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> Tuple:
        return placements(self.spec, self.mesh)


def param_shardings(params: Any, mesh: DeviceMesh) -> Any:
    """A :class:`NamedSharding` for every leaf of ``params``."""
    pp = mesh_shape(mesh).get("pp", 1)
    return _map_with_path(lambda path, x: NamedSharding(mesh, spec_with_pp(path, x.ndim, pp)), params)


def local_shape(shape: Sequence[int], sharding: NamedSharding, name: str = "") -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` laid out by
    ``sharding``; a sharded dim must divide by its axis's extent."""
    out = list(shape)
    mesh = sharding.mesh
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            if out[pl.dim] % mesh.size(i):
                raise ValueError(f"{name or 'leaf'} {tuple(shape)}: dim {pl.dim} does not divide by "
                                 f"{mesh.mesh_dim_names[i]}={mesh.size(i)}")
            out[pl.dim] //= mesh.size(i)
    return tuple(out)


def place(x: torch.Tensor, sharding: NamedSharding, name: str = "") -> torch.Tensor:
    """``x`` as a DTensor laid out by ``sharding`` (a DTensor with that layout
    stays as it is). Every rank passes the same full tensor; rank 0's is
    the one distributed. A sharded dim must divide by its axis's extent. On
    a mesh of one rank the DTensor holds ``x`` itself."""
    if isinstance(x, DTensor) and tuple(x.placements) == sharding.placements:
        return x
    if isinstance(x, DTensor):
        x = x.full_tensor()
    mesh = sharding.mesh
    local_shape(x.shape, sharding, name)
    if mesh.size() == 1:  # one rank: the tensor itself is its shard (no copy, no collective)
        out = DTensor.from_local(x.detach(), mesh, sharding.placements, run_check=False)
    else:
        out = distribute_tensor(x.detach(), mesh, sharding.placements)
    return out.requires_grad_(x.requires_grad)


def keep_shard(x: torch.Tensor, sharding: NamedSharding, name: str = "") -> torch.Tensor:
    """This rank's part of ``x`` as a DTensor laid out by ``sharding``, with
    no collective: every rank holds the same whole ``x`` (drawn from the
    same seed), and the part is a copy, so ``x`` can be freed. A replicated
    layout (and a mesh of one rank) keeps ``x`` itself."""
    local_shape(x.shape, sharding, name)
    part = _narrow(x, sharding.mesh, sharding.placements)
    if part is not x:
        part = part.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(part.detach(), sharding.mesh, sharding.placements, run_check=False)


def empty_shard(shape: Sequence[int], dtype: torch.dtype, sharding: NamedSharding, device, name: str = ""
                ) -> torch.Tensor:
    """An uninitialised DTensor of global ``shape`` laid out by ``sharding``:
    each rank allocates its own shard only."""
    local = torch.empty(local_shape(shape, sharding, name), dtype=dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False)


def shard_params(params: Any, mesh: DeviceMesh) -> Any:
    """``params`` as DTensors laid out by the registry (a new tree)."""
    shardings = param_shardings(params, mesh)
    return _map_with_path(lambda path, x: place(x, _get(shardings, path), "/".join(path)), params)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def batch_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Batch rows over both data axes (dp × fsdp)."""
    return NamedSharding(mesh, (DATA_AXES,))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This rank's contiguous block of rows of a (global) batch: block
    ``dp_index · fsdp + fsdp_index`` of ``dp · fsdp`` along the leading dim
    of every tensor with one; other leaves pass through."""
    n, i = axis_size(mesh, DATA_AXES), axis_index(mesh, DATA_AXES)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not divide by the {n} data ranks")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return one(batch)


# --------------------------------------------------------------------------
# collectives with gradients
# --------------------------------------------------------------------------


def _own_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((dist.get_world_size(group) * xs.shape[0],) + xs.shape[1:])
    _all_gather_single(out, xs, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // dist.get_world_size(group),) + xs.shape[1:])
    _reduce_scatter_single(out, xs, group=group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters the cotangent
    (``summed``: each rank's is a partial sum) or keeps this rank's chunk
    (the cotangent is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return _own_chunk(g, ctx.dim, ctx.group).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a tensor every rank holds whole;
    the backward all-gathers the chunks' cotangents."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_chunk(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _SumGrad(torch.autograd.Function):
    """The identity; the backward all-reduces the cotangent (each rank holds
    a partial sum of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def gather(x: torch.Tensor, dim: int, group, *, summed: bool = False) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group`` (module note on ``summed``)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group, summed)


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x`` (whole on every rank of ``group``)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _Scatter.apply(x, dim, group)


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, its cotangent all-reduced over ``group`` in the backward."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _SumGrad.apply(x, group)


# --------------------------------------------------------------------------
# the gather on use
# --------------------------------------------------------------------------


class LayerShard:
    """One layer of a stacked DTensor leaf: this rank's shard of it (a view
    of the leaf's local tensor) and the layout to gather it by."""

    __slots__ = ("local", "mesh", "placements")

    def __init__(self, local: torch.Tensor, mesh: DeviceMesh, placements: Sequence):
        self.local, self.mesh, self.placements = local, mesh, tuple(placements)

    @property
    def requires_grad(self) -> bool:
        return self.local.requires_grad


def gather_local(local: torch.Tensor, mesh: DeviceMesh, placements: Sequence, keep: Sequence[str] = ()
                 ) -> torch.Tensor:
    """The full tensor of a shard laid out by ``placements`` on ``mesh``
    (module note on the gradients); mesh axes in ``keep`` stay as they are."""
    x = local
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, placements)):
        if name in keep or mesh.size(i) == 1:
            continue
        if isinstance(pl, Shard):
            x = gather(x, pl.dim, mesh.get_group(i), summed=name in DATA_AXES)
        elif name in DATA_AXES:
            x = sum_grad(x, mesh.get_group(i))
    return x


def full(x):
    """A DTensor or :class:`LayerShard` → its full local tensor (through the
    collectives, differentiable); anything else unchanged."""
    if isinstance(x, DTensor):
        return gather_local(x.to_local(), x.device_mesh, x.placements)
    if isinstance(x, LayerShard):
        return gather_local(x.local, x.mesh, x.placements)
    return x


def full_tree(tree, skip: Sequence[str] = ()):
    """Every leaf of a nested dict (or a lone leaf) through :func:`full`,
    except the subtrees under the keys in ``skip`` (the stacked layers,
    gathered layer by layer). A tree without DTensor or :class:`LayerShard`
    leaves comes back as it is."""
    if not isinstance(tree, dict):
        return full(tree)
    if not is_sharded(tree):
        return tree
    return {k: (v if k in skip else full_tree(v, skip) if isinstance(v, dict) else full(v)) for k, v in tree.items()}


def is_sharded(tree) -> bool:
    if isinstance(tree, dict):
        return any(is_sharded(v) for v in tree.values())
    return isinstance(tree, (DTensor, LayerShard))


def unstack(x: torch.Tensor, stage: Optional[DeviceMesh] = None) -> List:
    """The per-layer pieces of a stacked leaf ``[L, ...]``.

    A plain tensor unbinds into its layers. A DTensor unbinds its local
    tensor into :class:`LayerShard` s, gathered later inside each layer's
    (recomputed) function; a layer dim sharded over ``pp`` is gathered first.
    With ``stage`` (a mesh with a ``pp`` axis: the pipeline), only this pp
    rank's ``L/pp`` layers: a DTensor's own stage, or its chunk of a
    tensor every rank holds whole (the backward all-gathers the chunks'
    gradients, as JAX's ``shard_map`` does for a replicated input)."""
    pp_dim = stage.mesh_dim_names.index("pp") if stage is not None else None
    if not isinstance(x, DTensor):
        if stage is not None:
            x = scatter(x, 0, stage.get_group(pp_dim))
        return list(x.unbind(0))
    mesh, pls = x.device_mesh, list(x.placements)
    local = x.to_local()
    staged = False
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard) and pl.dim == 0:
            name = mesh.mesh_dim_names[i]
            if stage is not None and name == "pp":
                staged = True
            elif mesh.size(i) > 1:
                local = gather(local, 0, mesh.get_group(i), summed=name in DATA_AXES)
            pls[i] = Replicate()
    if stage is not None and not staged:
        local = scatter(local, 0, stage.get_group(pp_dim))
    pls = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pls]
    return [LayerShard(v, mesh, pls) for v in local.unbind(0)]


def _narrow(value: torch.Tensor, mesh: DeviceMesh, placements: Sequence,
            dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's part (a view) of a full tensor laid out by ``placements``
    on ``mesh``; ``dims``: cut only these tensor dims."""
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1 and (dims is None or pl.dim in dims):
            size = value.shape[pl.dim] // mesh.size(i)
            value = value.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
    return value


def local_part(full_value: torch.Tensor, like: torch.Tensor, dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's part of a full tensor laid out as the DTensor ``like``
    (``full_value`` itself for a plain ``like``); ``dims``: cut only these
    tensor dims."""
    if not isinstance(like, DTensor):
        return full_value
    return _narrow(full_value, like.device_mesh, like.placements, dims)


def local(x):
    """A DTensor's local tensor; anything else unchanged."""
    return x.to_local() if isinstance(x, DTensor) else x


def sharded_dims(x) -> Tuple[int, ...]:
    """The mesh dims (of more than one rank) a DTensor is sharded over."""
    if not isinstance(x, DTensor):
        return ()
    mesh = x.device_mesh
    return tuple(i for i, pl in enumerate(x.placements) if isinstance(pl, Shard) and mesh.size(i) > 1)

