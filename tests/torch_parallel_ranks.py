"""One rank of the port's parallelism checks on the CPU (gloo), started by
``tests/test_torch_parallel.py`` once per rank:

    python tests/torch_parallel_ranks.py RANK WORLD DIR

It joins the world through a file store in DIR, runs each check on its
``DIR/inputs_<check>.pt`` (numpy-seeded inputs, weights converted from the
JAX package's, the port's configs) as soon as the test has written it, and
writes ``DIR/rank<RANK>.pt``:

- ``pipeline``: ``pipeline_decoder`` on ``(tp, pp)`` meshes ``(4, 2)`` and
  ``(2, 4)`` — the forward for each ``(pp, M)``, the gradients of
  ``mean(out²)`` over the layers and ``h``, the forward over stage-sharded
  params, ``forward_hidden(pipeline=...)``, the divisibility errors;
- ``train``: micro steps of ``make_train_step`` on ``dp2·tp2·pp2`` from the
  global batches' rows of this rank, with and without LoRA (loss,
  ``grad_norm``, the full params after); the last state saved, restored on
  ``fsdp4·tp2`` (each full tensor bit for bit) and stepped once more on both
  meshes; the sharded init (``init_train_state(mesh=...)``) on both meshes,
  with and without LoRA (rank 0's gathered state); the chunks each rank
  holds when it saves; and the peak of the live tensor bytes of the init,
  the save and the restore (:class:`LiveBytes`) beside the rank's share of
  the state and its largest leaf;
- ``ring``: the 24-view loss and gradients with VGGT's ring over ``fsdp`` of
  ``fsdp4·tp2`` (every rank with both rows), the trainer step on
  ``fsdp2·tp4`` (a row on each fsdp rank) with ``ring_axis="fsdp"`` and
  without, and the ``ring_axis`` error;
- ``infer``: generation on ``dp2·fsdp2·tp2`` with parameters placed by
  ``shard_params`` (``generate_text`` penalised, W8 with an int8 cache,
  ``generate_speculative``, ``generate_early_exit``).

It imports no JAX: the test holds the results to the JAX package in its own
process.
"""

import copy
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vggt_qwen3_tpu_torch.config import MeshConfig  # noqa: E402
from vggt_qwen3_tpu_torch.inference import engine  # noqa: E402
from vggt_qwen3_tpu_torch.inference.speculative import generate_speculative  # noqa: E402
from vggt_qwen3_tpu_torch.models import qwen3, vlm  # noqa: E402
from vggt_qwen3_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from vggt_qwen3_tpu_torch.parallel.multihost import global_batch_from_local  # noqa: E402
from vggt_qwen3_tpu_torch.parallel.pipeline import PipelinePlan, pipeline_decoder  # noqa: E402
from vggt_qwen3_tpu_torch.parallel.sharding import full, shard_batch, shard_params  # noqa: E402
from vggt_qwen3_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from vggt_qwen3_tpu_torch.train import trainer  # noqa: E402


def whole(tree):
    """Every leaf of a nested dict as its full tensor (a collective for DTensors)."""
    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    return full(tree).detach().clone() if isinstance(tree, torch.Tensor) else tree


def flat(tree, prefix="", sep="/"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}{sep}", sep))
        else:
            out[prefix + k] = v
    return out


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes of live tensors made under it: every storage an
    op's output brings (a DTensor's local tensor's) counts from when it is
    first seen until it is freed; the storages of ``existing`` (tensors that
    were there before) never count, nor do uint8 tensors: the pickled
    objects of the collectives (a checkpoint's plans and metadata, ~1 KB a
    leaf and rank; no leaf of a train state is uint8)."""

    def __init__(self, existing=()):
        super().__init__()
        self.skip = {StorageWeakRef(self._plain(t).untyped_storage()).cdata for t in existing}
        self.live, self.peak = {}, 0

    @staticmethod
    def _plain(t):
        return t._local_tensor if isinstance(t, DTensor) else t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            t = self._plain(t)
            if type(t) is not torch.Tensor or t.device.type == "meta" or t.dtype == torch.uint8:
                continue
            ref = StorageWeakRef(t.untyped_storage())
            if ref.cdata not in self.skip and (ref.cdata not in self.live or self.live[ref.cdata][0].expired()):
                self.live[ref.cdata] = (ref, t.untyped_storage().nbytes())
        self.live = {k: v for k, v in self.live.items() if not v[0].expired()}
        self.peak = max(self.peak, sum(n for _, n in self.live.values()))
        return out


def tensors(tree):
    """Every tensor leaf of a nested dict (or a train state's trees)."""
    if isinstance(tree, trainer.TrainState):
        return tensors(tree.params) + tensors(tree.opt_state)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def footprint(state, peak: int, before: int = 0):
    """A rank's bytes: its share of ``state`` (the local shards, and the
    leaves it holds whole), the largest leaf whole, and the peak of the live
    bytes (those of tensors that were there before, ``before``, plus the
    peak of those made since)."""
    local = [LiveBytes._plain(t) for t in tensors(state)]
    whole_bytes = [t.numel() * t.element_size() for t in tensors(state)]
    return dict(share=sum(t.untyped_storage().nbytes() for t in local), peak=before + peak,
                largest=max(whole_bytes), total=sum(whole_bytes))


def held_chunks(state):
    """(DCP's name, offsets) of every chunk this rank holds of a saved train
    state: its own shard of each DTensor, every plain tensor whole, and the
    other values (offsets None). DCP names a leaf by its keys joined with
    "." (an optimizer leaf's key is its parameter's path, slashes and all)."""
    out = {("leaves", None)}
    for name, x in flat({"params": state.params, "opt_state": state.opt_state, "step": state.step}, sep=".").items():
        if isinstance(x, DTensor):
            out |= {(name, tuple(c.offsets)) for c in x.__create_chunk_list__()}
        else:
            out.add((name, (0,) * x.ndim if isinstance(x, torch.Tensor) else None))
    return out


def grads_of(tree):
    return {n: (None if p.grad is None else full(p.grad).clone()) for n, p in trainer.named_leaves(tree)}


def pipeline_checks(inp):
    cfg, layers = inp["cfg"], inp["params"]["layers"]
    h, cos, sin, mask = inp["h"], inp["cos"], inp["sin"], inp["mask"]
    fn = lambda *a: qwen3.train_layer(cfg, *a)  # noqa: E731
    res = {"fwd": {}}
    meshes = {pp: build_mesh(MeshConfig(tp=8 // pp, pp=pp)) for pp in (2, 4)}
    for pp, M in ((2, 2), (2, 4), (4, 4)):
        with torch.no_grad():
            res["fwd"][(pp, M)] = pipeline_decoder(layers, h, cos, sin, mask, plan=PipelinePlan(meshes[pp], M),
                                                   layer_fn=fn)
    plan = PipelinePlan(meshes[2], 4)
    lg = {k: v.clone().requires_grad_(True) for k, v in layers.items()}
    hg = h.clone().requires_grad_(True)
    (pipeline_decoder(lg, hg, cos, sin, mask, plan=plan, layer_fn=fn) ** 2).mean().backward()
    res["grads"] = {"layers": {k: v.grad for k, v in lg.items()}, "h": hg.grad}

    staged = shard_params({"text": inp["params"]}, meshes[2])["text"]["layers"]
    res["staged_placement"] = str(staged["wq"].placements)
    res["staged_local_layers"] = staged["wq"].to_local().shape[0]
    with torch.no_grad():
        res["staged"] = pipeline_decoder(staged, h, cos, sin, mask, plan=PipelinePlan(meshes[2], 2), layer_fn=fn)
        res["forward_hidden"] = qwen3.forward_hidden(inp["params"], cfg, h, attention_mask=inp["amask"],
                                                     pipeline=PipelinePlan(meshes[2], 2))[0]
    errors = []
    for bad_layers, M in ((layers, 3), (inp["params3"]["layers"], 2)):
        try:
            pipeline_decoder(bad_layers, h, cos, sin, mask, plan=PipelinePlan(meshes[2], M), layer_fn=fn)
        except ValueError as e:
            errors.append(str(e))
    res["errors"] = errors
    return res


def first_gradients(stage, params, inp):
    """The first micro step's gradients, unsharded (where they are rounding
    noise around an exact 0, Adam's steps are of either sign)."""
    first = copy.deepcopy(params)
    for _, p in trainer.named_leaves(first):
        p.requires_grad_(True)
    b = inp["batches"][0]
    vlm.train_forward(first, stage.model, images=b["pixel_values"], geom_token=b["geom_token"],
                      input_ids=b["input_ids"], attention_mask=b["attention_mask"], labels=b["labels"],
                      image_token_id=inp["img_id"]).backward()
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad) for n, p in trainer.named_leaves(first)}


def train_checks(inp, out_dir):
    res = {}
    mesh = build_mesh(MeshConfig(dp=2, tp=2, pp=2))
    for lora in (False, True):
        stage = inp["stages"][lora]
        params = copy.deepcopy(inp["params"][lora])
        grads = first_gradients(stage, params, inp) if dist.get_rank() == 0 else None
        tx = trainer.make_tx(stage, params)
        state = trainer.TrainState(params=params, opt_state=tx.init(params), step=0)
        shardings = trainer.state_shardings(state, mesh)
        step = trainer.make_train_step(stage, tx, inp["img_id"], has_geom=True, state_sharding=shardings)
        metrics = []
        for b in inp["batches"]:
            state, m = step(state, shard_batch(b, mesh), None)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        rows = global_batch_from_local(shard_batch(b, mesh), mesh)  # this rank's rows as the global batch
        res["global_batch"] = all(torch.equal(rows[k].full_tensor(), b[k]) for k in ("input_ids", "pixel_values"))
        res[lora] = {"metrics": metrics, "params": whole(state.params), "grads": grads,
                     "gradient_step": state.opt_state["gradient_step"],
                     "placements": {n: str(p.placements) for n, p in trainer.named_leaves(state.params)}}
    # the last state, saved and restored on another mesh shape, then one more micro step on each
    path = out_dir / "ckpt" / "step_4"
    saved = lambda st: flat(whole({"params": st.params, "mu": st.opt_state["mu"], "nu": st.opt_state["nu"],  # noqa: E731
                                   "acc": st.opt_state["acc"]}))
    before = saved(state)
    with LiveBytes(existing=tensors(state)) as live:
        ckpt.save(state, path)
    res["save_bytes"] = footprint(state, live.peak, before=footprint(state, 0)["share"])
    res["held_chunks"] = held_chunks(state)
    other = build_mesh(MeshConfig(fsdp=4, tp=2))
    with LiveBytes() as live:
        restored = ckpt.restore(path, "cpu", mesh=other)
    res["restore_bytes"] = footprint(restored, live.peak)
    after = saved(restored)
    res["restore_exact"] = before.keys() == after.keys() and all(torch.equal(before[n], after[n]) for n in before)
    res["saved"] = before if dist.get_rank() == 0 else None
    res["ckpt_dir"] = str(path)
    res["restored_placement"] = str(restored.params["text"]["layers"]["wq"].placements)
    stage = inp["stages"][True]
    b = inp["batches"][0]
    _, m1 = step(state, shard_batch(b, mesh), None)
    step2 = trainer.make_train_step(stage, trainer.make_tx(stage, restored.params), inp["img_id"], has_geom=True,
                                    state_sharding=trainer.state_shardings(restored, other))
    _, m2 = step2(restored, shard_batch(b, other), None)
    res["next_loss"] = (m1["loss"].item(), m2["loss"].item())
    res["init"] = init_checks(inp)
    return res


INIT_SEED = 5
INIT_MESHES = {"dp2_tp2_pp2": MeshConfig(dp=2, tp=2, pp=2), "fsdp4_tp2": MeshConfig(fsdp=4, tp=2)}


def init_checks(inp):
    """``init_train_state(mesh=...)`` from ``INIT_SEED`` on each mesh, with
    and without LoRA: rank 0's gathered state, whether every moment is a
    zero of its parameter's local shape, and the bytes (:func:`footprint`)."""
    res = {}
    for mesh_name, shape in INIT_MESHES.items():
        mesh = build_mesh(shape)
        for lora in (False, True):
            with LiveBytes() as live:
                state, _ = trainer.init_train_state(torch.Generator().manual_seed(INIT_SEED), inp["stages"][lora],
                                                    dtype="float32", mesh=mesh)
            params = dict(trainer.named_leaves(state.params))
            full_state = {"params": whole(state.params), "mu": whole(state.opt_state["mu"]),
                          "nu": whole(state.opt_state["nu"])}
            res[(mesh_name, lora)] = dict(
                footprint(state, live.peak), state=full_state if dist.get_rank() == 0 else None,
                placements={n: str(p.placements) for n, p in params.items()},
                local_zeros=all(m.to_local().shape == params[n].to_local().shape and not m.to_local().any()
                                for key in ("mu", "nu") for n, m in state.opt_state[key].items()))
    return res


def ring_checks(inp):
    res = {}
    mesh = build_mesh(MeshConfig(fsdp=4, tp=2))
    cfg, params = inp["cfg"], copy.deepcopy(inp["params"])
    for p in trainer.named_leaves(params):
        p[1].requires_grad_(True)
    loss = vlm.train_forward(params, cfg, images=inp["images"], geom_token=None, input_ids=inp["ids"],
                             attention_mask=inp["mask"], labels=inp["labels"], image_token_id=500,
                             ring_group=mesh.get_group("fsdp"))
    loss.backward()
    res["loss"] = loss.item()
    res["grads"] = grads_of(params)

    stage = inp["stage"]
    mesh = build_mesh(MeshConfig(fsdp=2, tp=4))
    batch = {"pixel_values": inp["images"], "input_ids": inp["ids"], "attention_mask": inp["mask"],
             "labels": inp["labels"]}
    losses = {}
    for ring in (None, "fsdp"):
        p = copy.deepcopy(inp["params"])
        tx = trainer.make_tx(stage, p)
        state = trainer.TrainState(params=p, opt_state=tx.init(p), step=0)
        step = trainer.make_train_step(stage, tx, 500, has_geom=False,
                                       state_sharding=trainer.state_shardings(state, mesh), ring_axis=ring)
        _, m = step(state, shard_batch(batch, mesh), None)
        losses[ring] = m["loss"].item()
    res["step_losses"] = losses
    try:
        trainer.make_train_step(stage, tx, 500, has_geom=False, state_sharding=trainer.state_shardings(state, mesh),
                                ring_axis="pp")
    except ValueError as e:
        res["extent_error"] = str(e)
    return res


def infer_checks(inp):
    res = {}
    mesh = build_mesh(MeshConfig(dp=2, fsdp=2, tp=2))
    cfg = inp["cfg"]
    with torch.no_grad():
        c = inp["text"]
        sharded = shard_params(c["params"], mesh)
        res["wq_placement"] = str(sharded["layers"]["wq"].placements)
        res["text"] = engine.generate_text(sharded, cfg, c["gen_cfg"], input_ids=c["ids"])
        c = inp["w8"]
        sharded = shard_params(qwen3.quantize_params(c["params"]), mesh)
        res["w8_placement"] = str(sharded["layers"]["wq"]["w8"].placements)
        res["w8"] = engine.generate_text(sharded, cfg, c["gen_cfg"], input_ids=c["ids"])
        c = inp["spec"]
        sharded = shard_params(c["params"], mesh)
        mask = torch.ones(c["ids"].shape, dtype=torch.int32)
        res["spec"] = generate_speculative(sharded, cfg, c["gen_cfg"], inputs_embeds=qwen3.embed_tokens(
            sharded, c["ids"]), attention_mask=mask, prompt_ids=c["ids"], draft_k=4, ngram=3)[:2]
        c = inp["early"]
        sharded = shard_params(c["params"], mesh)
        mask = torch.ones(c["ids"].shape, dtype=torch.int32)
        res["early"] = engine.generate_early_exit(sharded, cfg, c["gen_cfg"], inputs_embeds=qwen3.embed_tokens(
            sharded, c["ids"]), attention_mask=mask, budget=[6, 4])
    return res


def inputs(out_dir: Path, name: str):
    """``DIR/inputs_<name>.pt``, waiting until the test has written it (it
    builds each check's inputs while the ranks start and run the earlier ones)."""
    path = out_dir / f"inputs_{name}.pt"
    for _ in range(6000):
        if path.exists():
            return torch.load(path, weights_only=False)
        time.sleep(0.1)
    raise TimeoutError(f"no {path}")


def main(rank: int, world: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(out_dir / "store"), world), rank=rank,
                            world_size=world)
    try:
        res = {}
        for name, fn in (("pipeline", pipeline_checks), ("infer", infer_checks), ("ring", ring_checks)):
            res[name] = fn(inputs(out_dir, name))
        res["train"] = train_checks(inputs(out_dir, "train"), out_dir)
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "vggt_qwen3_tpu") for m in sys.modules)
        torch.save(res, out_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
