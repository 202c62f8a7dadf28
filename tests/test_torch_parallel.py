"""The port's parallelism (``vggt_qwen3_tpu_torch/parallel/``, the meshed
trainer, the ring in training, generation with sharded parameters, the sft
CLI across processes) against the JAX package's.

Eight gloo ranks, each a process of its own that imports no JAX
(``tests/torch_parallel_ranks.py``, a file store in a temporary directory),
run the port once on every check's inputs while this process computes the
JAX package's results on its 8 forced host devices. Both sides get the same
weights (JAX ``init_params`` / ``init_train_state`` → ``utils.from_jax``) and
numpy-seeded inputs. Tolerances:

- the registry: spec for spec equal to JAX's ``param_shardings`` and
  ``trainer.state_shardings`` over the full-size stage-1 and stage-2 trees
  (shapes only: ``jax.eval_shape`` and meta tensors), LoRA and 8-bit
  moments included;
- ``pipeline_decoder`` (``tests/test_pipeline.py``'s shapes): forward for
  (pp, M) ∈ {(2, 2), (2, 4), (4, 4)} within 2e-5 of JAX's pipeline, the
  gradients of the layers and ``h`` within 3e-5, stage-sharded params and
  ``forward_hidden(pipeline=...)`` within 2e-5, JAX's divisibility errors;
- four micro steps (two updates) on ``dp2·tp2·pp2``, with and without LoRA,
  the tower unfrozen: loss and ``grad_norm`` rtol 1e-5 of JAX's jitted
  sharded step, the parameters after within 1e-5 (atol and rtol) but for
  elements whose gradient is 0 in exact arithmetic (held to the step's
  size), as ``tests/test_torch_train_slice.py`` holds them; the state saved
  and restored on ``fsdp4·tp2`` bit for bit, one more micro step on either
  mesh within rtol 2e-5;
- the sharded train state's life cycle (``init_train_state(mesh=...)``,
  ``checkpoint.save`` / ``restore``): the init on ``dp2·tp2·pp2`` and
  ``fsdp4·tp2``, with and without LoRA, bit for bit one process's unsharded
  init from the same seed; each rank's checkpoint file holding only chunks
  that rank holds, every leaf named once in the metadata and every element
  stored once; the checkpoint read whole in one process (``restore``
  without a process group, ``qa.load_model``) bit for bit; and a rank's
  peak of live tensor bytes during the init, the save and the restore at
  most its share of the state plus the largest leaf, plus 64 KiB;
- the 24-view ring (``tests/test_ring_e2e.py``'s model, the tower unfrozen):
  loss rtol 2e-5, gradients rtol 5e-4 / atol 1e-5 of JAX's ring over
  ``fsdp4·tp2`` (rows on every rank); the trainer step with
  ``ring_axis="fsdp"`` on ``fsdp2·tp4`` (a row on each fsdp rank) and
  without: its loss (the params' before the update) rtol 2e-5 of JAX's; the
  ``ring_axis`` errors;
- generation with sharded parameters (``tests/test_sharded_inference.py``'s
  four cases, ``fsdp2·tp2`` in each of two ``dp`` replicas): tokens identical
  to JAX's on its ``fsdp2·tp2`` mesh;
- the sft CLI over 2 ranks (``--fsdp 2``) and 4 ranks (``--fsdp 2 --tp 2``)
  on ``configs/toy.yaml --tiny --mock_vision`` with Perceiver dropout on:
  rank 0's losses within rtol 2e-5 of one process's over the same global
  batch; the 2-rank run's checkpoint resumes in one process to those losses.
"""

import ast
import dataclasses
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.inference import engine as jengine
from vggt_qwen3_tpu.inference.speculative import generate_speculative as jgenerate_speculative
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.models import vlm as jvlm
from vggt_qwen3_tpu.ops.attention import make_causal_mask as jcausal
from vggt_qwen3_tpu.ops.rope import rope_cos_sin as jrope
from vggt_qwen3_tpu.parallel import pipeline as jpipeline
from vggt_qwen3_tpu.parallel.mesh import build_mesh as jbuild_mesh
from vggt_qwen3_tpu.parallel.sharding import param_shardings as jparam_shardings
from vggt_qwen3_tpu.parallel.sharding import path_keys as jpath_keys
from vggt_qwen3_tpu.parallel.sharding import shard_batch as jshard_batch
from vggt_qwen3_tpu.train import trainer as jtrainer
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.data import collator as pcollator
from vggt_qwen3_tpu_torch.data.tokenizer import IMAGE_TOKEN, load_tokenizer
from vggt_qwen3_tpu_torch.inference import engine as pengine
from vggt_qwen3_tpu_torch.parallel import sharding as psharding
from vggt_qwen3_tpu_torch.parallel.mesh import build_mesh as pbuild_mesh
from vggt_qwen3_tpu_torch.inference import qa as pqa
from vggt_qwen3_tpu_torch.train import checkpoint as pckpt
from vggt_qwen3_tpu_torch.train import sft, trainer as ptrainer
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax
from tests.torch_parallel_ranks import INIT_MESHES, INIT_SEED, flat

REPO = Path(__file__).resolve().parents[1]
RANKS = 8


def port(obj):
    """A JAX config dataclass (nested) as the port's, field for field."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(pconfig, type(obj).__name__)
        return cls(**{f.name: port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(x):
    return params_from_jax(jax.tree.map(np.asarray, x))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# inputs of each check, and the JAX package's results
# ---------------------------------------------------------------------------

PIPE_CFG = jconfig.Qwen3Config(vocab_size=128, hidden_size=48, num_layers=4, num_heads=4, num_kv_heads=2,
                               head_dim=12, intermediate_size=96, rope_theta=10_000.0, dtype="float32")


def pipeline_case(inputs: bool = True):
    cfg3 = dataclasses.replace(PIPE_CFG, num_layers=3)
    params, params3 = jax.jit(lambda: (jqwen3.init_params(jax.random.PRNGKey(0), PIPE_CFG, dtype="float32"),
                                       jqwen3.init_params(jax.random.PRNGKey(1), cfg3, dtype="float32")))()
    B, S = 4, 10
    h = jnp.asarray(np.random.default_rng(0).normal(size=(B, S, PIPE_CFG.hidden_size)) * 0.1, jnp.float32)
    cos, sin = jrope(jnp.broadcast_to(jnp.arange(S)[None], (B, S)), PIPE_CFG.head_dim, PIPE_CFG.rope_theta)
    mask = jcausal(S, S)[None, None]
    amask = jnp.ones((B, S), jnp.int32).at[:, -2:].set(0)
    inputs = dict(cfg=port(PIPE_CFG), params=_tree(params), params3=_tree(params3), h=_t(h), cos=_t(cos),
                  sin=_t(sin), mask=_t(mask), amask=_t(amask))

    def reference():
        def layer_fn(hh, lp, c, s, m):
            return jqwen3._layer_step(PIPE_CFG, hh, lp, None, None, c, s, m, 0)[0]

        meshes = {pp: jbuild_mesh(jconfig.MeshConfig(tp=8 // pp, pp=pp)) for pp in (2, 4)}
        ref = {"fwd": {}}
        for pp, M in ((2, 2), (4, 4)):
            plan = jpipeline.PipelinePlan(mesh=meshes[pp], num_microbatches=M)
            ref["fwd"][(pp, M)] = np.asarray(jax.jit(lambda ls: jpipeline.pipeline_decoder(
                ls, h, cos, sin, mask, plan=plan, layer_fn=layer_fn))(params["layers"]))
        plan = jpipeline.PipelinePlan(mesh=meshes[2], num_microbatches=4)

        def loss(layers, hh):
            out = jpipeline.pipeline_decoder(layers, hh, cos, sin, mask, plan=plan, layer_fn=layer_fn)
            return (out.astype(jnp.float32) ** 2).mean(), out

        (_, out), (gl, gh) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params["layers"], h)
        ref["fwd"][(2, 4)] = np.asarray(out)
        ref["grads"] = {"layers": jax.tree.map(np.asarray, gl), "h": np.asarray(gh)}
        plan = jpipeline.PipelinePlan(mesh=meshes[2], num_microbatches=2)
        ref["forward_hidden"] = np.asarray(jax.jit(lambda p: jqwen3.forward_hidden(
            p, PIPE_CFG, h, attention_mask=amask, pipeline=plan)[0])(params))
        return ref

    return inputs, {None: reference}


IMG = jconfig.VGGT_TINY.img_size


def _records(n: int, views: int, seed: int):
    rng = np.random.default_rng(seed)
    qs = ["Is there a table in this room?", "What color is the chair?", "How many beds are visible?"]
    out = []
    for i in range(n):
        geom = None if i % 3 == 2 else {
            "R": rng.standard_normal((views, 9)).tolist(), "t": rng.standard_normal((views, 3)).tolist(),
            "K": rng.standard_normal((views, 9)).tolist(), "depth_hist": rng.random((views, 16)).tolist()}
        out.append(dict(images=[rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(views)],
                        question=qs[i % 3], answer=["yes", {"n": i}, "in the corner"][i % 3], geom_token=geom))
    return out


def _train_stage(lora: bool):
    model = jconfig.VLMConfig(
        text=dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32"), vision=jconfig.VGGT_TINY,
        projector=jconfig.PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128,
                                          dropout=0.0),
        num_vis_tokens=16, geom_tokens=2, freeze_vision=False, dtype="float32")
    return jconfig.StageConfig(
        model=model, data=jconfig.DataConfig(num_views=2, image_size=IMG, max_length=64),
        train=jconfig.TrainConfig(lr=2e-3, proj_lr=1e-2, weight_decay=0.1, warmup_ratio=0.25, max_steps=8,
                                  grad_accum=2, gradient_clip=0.5, batch_size_per_device=2, seed=3),
        lora=jconfig.LoRAConfig(enable=lora, rank=4, alpha=8), freeze_text_layers=(0,),
        mesh=jconfig.MeshConfig(dp=2, tp=2, pp=2))


def _batch_np(tok, step):
    col = pcollator.MultiViewCollator(IMG, tok, 64, num_vis_tokens=16, geom_tokens=2, view_dropout=0.3, seed=3,
                                      pad_to=96, emit_geom=True)
    return col(_records(8, 2, seed=10 + step), batch_index=step)


def _batch(b, to):
    out = {k: to(v) for k, v in b.items() if k != "geom_token"}
    out["geom_token"] = {k: to(v) for k, v in b["geom_token"].items() if k != "mask"}
    return out


def _train_state(stage):
    return jax.jit(lambda rng: jtrainer.init_train_state(rng, stage, dtype="float32")[0])(jax.random.PRNGKey(0))


def train_case(inputs: bool = True):
    tok = load_tokenizer(None)
    img_id = tok.convert_tokens_to_ids(IMAGE_TOKEN)
    batches = [_batch_np(tok, s) for s in range(4)]
    stages = {lora: _train_stage(lora) for lora in (False, True)}
    if inputs:
        inputs = dict(stages={k: port(v) for k, v in stages.items()}, img_id=img_id,
                      params={k: _tree(_train_state(v).params) for k, v in stages.items()},
                      batches=[_batch(b, _t) for b in batches])

    def reference(lora):
        mesh = jbuild_mesh(jconfig.MeshConfig(dp=2, tp=2, pp=2))
        stage = stages[lora]
        state = _train_state(stage)
        tx = jtrainer.make_tx(stage, state.params)
        init = _flat(jax.tree.map(np.asarray, state.params))
        shardings = jtrainer.state_shardings(state, mesh)
        state = jax.device_put(state, shardings)
        step = jtrainer.make_train_step(stage, tx, img_id, has_geom=True, state_sharding=shardings)
        metrics = []
        for s, b in enumerate(batches):
            state, m = step(state, jshard_batch(_batch(b, jnp.asarray), mesh), jax.random.PRNGKey(s))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return dict(metrics=metrics, params=_flat(jax.tree.map(np.asarray, state.params)), init=init)

    return inputs, {lora: (lambda lora=lora: reference(lora)) for lora in (False, True)}


RING_TEXT = jconfig.Qwen3Config(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                                head_dim=16, intermediate_size=128, rope_theta=1e4, tie_word_embeddings=True,
                                dtype="float32")
RING_CFG = jconfig.VLMConfig(
    text=RING_TEXT,
    vision=jconfig.VGGTConfig(img_size=56, patch_size=14, embed_dim=32, num_layers=2, num_heads=2,
                              num_register_tokens=4, patch_depth=2, dtype="float32"),
    projector=jconfig.PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128,
                                      dropout=0.0),
    num_vis_tokens=16, geom_tokens=0, freeze_vision=False, vision_backbone="vggt", dtype="float32")


def _ring_batch(B=2, T=48):
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (B, 24, 3, 56, 56)).astype(np.float32)
    ids = rng.integers(1, 400, size=(B, T))
    ids[:, 4] = 500
    labels = np.where(np.arange(T)[None] < 8, -100, ids)
    return images, ids, np.ones((B, T), np.int32), labels


def ring_case(inputs: bool = True):
    params = jax.jit(lambda: jvlm.init_params(jax.random.PRNGKey(0), RING_CFG, dtype="float32"))()
    images, ids, mask, labels = _ring_batch()
    if inputs:
        # the trainer's stage: its step starts from init_train_state's params at PRNGKey(0), these
        stage = jconfig.StageConfig(
            model=RING_CFG, data=jconfig.DataConfig(),
            train=jconfig.TrainConfig(lr=5e-6, proj_lr=1e-4, warmup_ratio=0.03, max_steps=10, grad_accum=1,
                                      batch_size_per_device=1))
        inputs = dict(cfg=port(RING_CFG), params=_tree(params), images=_t(images), ids=_t(ids), mask=_t(mask),
                      labels=_t(labels), stage=port(stage))

    def reference():
        mesh = jbuild_mesh(jconfig.MeshConfig(dp=1, fsdp=4, tp=2))

        def f(p):
            return jvlm.train_forward(p, RING_CFG, images=jnp.asarray(images), geom_token=None,
                                      input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                      labels=jnp.asarray(labels), image_token_id=500, ring_mesh=mesh,
                                      ring_axis="fsdp")

        loss, grads = jax.jit(jax.value_and_grad(f))(params)
        return dict(loss=float(loss), grads=_flat(jax.tree.map(np.asarray, grads)))

    return inputs, {None: reference}


INFER_CFG = jconfig.Qwen3Config(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                                head_dim=16, intermediate_size=128, rope_theta=1e4, tie_word_embeddings=True,
                                dtype="float32")


def infer_case(inputs: bool = True):
    init = jax.jit(lambda: {s: jqwen3.init_params(jax.random.PRNGKey(s), INFER_CFG, dtype="float32")
                            for s in range(4)})()
    ids = {s: np.random.default_rng(s).integers(1, 512, shape) for s, shape in
           ((0, (4, 9)), (1, (2, 7)), (2, (2, 9)), (3, (2, 8)))}
    gen = {
        "text": dict(max_new_tokens=10, repetition_penalty=1.1, penalize_prompt=True, pad_token_id=0),
        "w8": dict(max_new_tokens=8, pad_token_id=0, kv_dtype="int8"),
        "spec": dict(max_new_tokens=12, repetition_penalty=1.1, pad_token_id=0),
        "early": dict(max_new_tokens=10, pad_token_id=0),
    }
    inputs = {"cfg": port(INFER_CFG)}
    for s, name in enumerate(gen):
        inputs[name] = dict(params=_tree(init[s]), ids=_t(ids[s]), gen_cfg=pengine.GenerationConfig(**gen[name]))

    def reference():
        mesh = jbuild_mesh(jconfig.MeshConfig(dp=1, fsdp=2, tp=2), jax.devices()[:4])

        def placed(p):
            return jax.device_put(p, jparam_shardings(p, mesh))

        ref = {}
        cfg = {k: jengine.GenerationConfig(**v) for k, v in gen.items()}
        ref["text"] = np.asarray(jengine.generate_text(placed(init[0]), INFER_CFG, cfg["text"],
                                                       input_ids=jnp.asarray(ids[0]))[0])
        ref["w8"] = np.asarray(jengine.generate_text(placed(jqwen3.quantize_params(init[1])), INFER_CFG, cfg["w8"],
                                                     input_ids=jnp.asarray(ids[1]))[0])
        p = placed(init[2])
        toks, lens, _ = jgenerate_speculative(
            p, INFER_CFG, cfg["spec"], inputs_embeds=jqwen3.embed_tokens(p, jnp.asarray(ids[2])),
            attention_mask=jnp.ones(ids[2].shape, jnp.int32), prompt_ids=jnp.asarray(ids[2]), draft_k=4, ngram=3)
        ref["spec"] = (np.asarray(toks), np.asarray(lens))
        p = placed(init[3])
        toks, lens, steps = jengine.generate_early_exit(
            p, INFER_CFG, cfg["early"], inputs_embeds=jqwen3.embed_tokens(p, jnp.asarray(ids[3])),
            attention_mask=jnp.ones(ids[3].shape, jnp.int32), budget=np.array([6, 4]))
        ref["early"] = (np.asarray(toks), np.asarray(lens), int(steps))
        return ref

    return inputs, {None: reference}


CASES = {"pipeline": pipeline_case, "infer": infer_case, "ring": ring_case, "train": train_case}  # the ranks' order
IN_CHILDREN = {"train": (False, True), "ring": (None,)}  # the slow compiles


def reference_child(name: str, part: str, out: str) -> None:
    """Compute one part of a case's JAX results in a process of its own
    (``python -c``; the case's inputs are rebuilt there, the same bits) and
    pickle it to ``out``."""
    with open(out, "wb") as f:
        pickle.dump(CASES[name](inputs=False)[1][ast.literal_eval(part)](), f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8 ranks run every check once, each as soon as its inputs are
    written, while JAX's results are computed, the slow parts in processes of
    their own → (JAX's results, [each rank's results])."""
    d = tmp_path_factory.mktemp("parallel")
    children = {(name, part): subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); import tests.conftest; "
         "from tests.test_torch_parallel import reference_child; reference_child(*sys.argv[2:])",
         str(REPO), name, repr(part), str(d / f"ref_{name}_{part}.pkl")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, parts in IN_CHILDREN.items() for part in parts}
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")  # the ranks talk over loopback only
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_parallel_ranks.py"), str(r),
                               str(RANKS), str(d)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    try:
        cases = {}
        for name, make in CASES.items():  # each check's inputs, in the order the ranks take them
            cases[name] = make()
            torch.save(cases[name][0], d / f"inputs_{name}.tmp")
            os.replace(d / f"inputs_{name}.tmp", d / f"inputs_{name}.pt")
        refs = {name: fns[None]() for name, (_, fns) in cases.items() if name not in IN_CHILDREN}
        logs = [p.communicate(timeout=400)[0] for p in procs]
        child_logs = {key: p.communicate(timeout=400)[0] for key, p in children.items()}
    finally:
        for p in procs + list(children.values()):
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    assert all(p.returncode == 0 for p in children.values()), "\n".join(log[-3000:] for log in child_logs.values())
    for (name, part) in children:
        with open(d / f"ref_{name}_{part}.pkl", "rb") as f:
            refs.setdefault(name, {})[part] = pickle.load(f)
    refs = {name: got.get(None, got) for name, got in refs.items()}
    return refs, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v.shape, device="meta") for k, v in tree.items()}


def _jspec(spec, ndim):
    dims = list(spec) + [None] * (ndim - len(spec))
    return tuple(d if not isinstance(d, list) else tuple(d) for d in dims)


@pytest.mark.parametrize("yaml", ["stage1_3d", "stage2_arkit"])
@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_registry_matches_jax_spec_for_spec(yaml, optimizer):
    jstage = jconfig.load_stage_config(REPO / "configs" / f"{yaml}.yaml")
    jstage = dataclasses.replace(jstage, train=dataclasses.replace(jstage.train, optimizer=optimizer))
    pstage = port(jstage)
    assert jstage.lora.enable and jstage.train.grad_accum > 1

    def init_fn(rng):
        return jtrainer.init_train_state(rng, jstage, dtype=jstage.model.dtype)[0]

    shape = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    params = _meta(shape.params)
    pstate = ptrainer.TrainState(params=params, opt_state=ptrainer.make_tx(pstage, params).init(params), step=0)
    for pp in (1, 2):
        mesh = jbuild_mesh(jconfig.MeshConfig(dp=2, fsdp=2, tp=2 // pp, pp=pp))
        jsh = jtrainer.state_shardings(shape, mesh)
        specs = ptrainer.state_specs(pstate, pp)
        assert specs.params == psharding.param_specs(params, pp)
        jparams = {"/".join(jpath_keys(p)): _jspec(s.spec, len(x.shape)) for (p, s), x in zip(
            jax.tree_util.tree_flatten_with_path(jparam_shardings(shape.params, mesh))[0],
            jax.tree.leaves(shape.params))}
        assert jparams == {n: _jspec(s, len(jparams[n])) for n, s in _flat_specs(specs.params).items()}
        assert any(s[0] == "pp" for n, s in jparams.items() if n.startswith("text/layers/")) == (pp > 1)
        # every optimizer leaf of JAX's state that mirrors a parameter, under the port's name for it
        counted = {"mu": 0, "nu": 0, "acc": 0}
        jopt = jax.tree_util.tree_flatten_with_path(jsh.opt_state)[0]
        jshapes = jax.tree.leaves(shape.opt_state)
        for (path, sh), leaf in zip(jopt, jshapes):
            keys = [k.lstrip(".") for k in jpath_keys(path)]
            kind = next((k for k in keys if k in ("mu", "nu", "mu_q", "nu_q", "acc_grads")), None)
            if kind is None:  # counters
                assert len(leaf.shape) == 0 and tuple(sh.spec) == ()
                continue
            rest = keys[keys.index(kind) + 1:]
            ours = {"mu": "mu", "nu": "nu", "mu_q": "mu", "nu_q": "nu", "acc_grads": "acc"}[kind]
            want = _jspec(sh.spec, len(leaf.shape))
            if kind in ("mu_q", "nu_q"):
                got = specs.opt_state[ours]["/".join(rest[:-1])][rest[-1]]
                # JAX means these block moments to replicate (trainer.py:214-219), but its path keys
                # read ".mu_q", so the rule misses and a text layer's blocks take the pp stage rule
                if pp > 1 and rest[:2] == ["text", "layers"]:
                    assert want == ("pp", None), (keys, want)
                    want = (None, None)
            else:
                got = specs.opt_state[ours]["/".join(rest)]
            assert _jspec(got, len(leaf.shape)) == want, (keys, got, sh.spec)
            counted[ours] += 1
        assert counted["acc"] == len(jparams) and counted["mu"] == counted["nu"] > 0
        assert counted["mu"] == len(specs.opt_state["mu"]) * (2 if optimizer == "adamw8bit" else 1)


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_placements_follow_the_spec_on_a_mesh_of_one():
    """On a 1-rank gloo world the mesh is ``(1, 1, 1, 1)`` by default (every
    rank on ``fsdp``), the placements shard where the spec says, and a
    gather of a 1-rank DTensor is its local tensor itself."""
    from torch.distributed.tensor import Replicate, Shard

    from vggt_qwen3_tpu_torch.ops.ring_attention import single_rank_group

    with single_rank_group("cpu"):
        mesh = pbuild_mesh()
        assert mesh.mesh_dim_names == ("dp", "fsdp", "tp", "pp") and tuple(mesh.mesh.shape) == (1, 1, 1, 1)
        assert psharding.placements((None, "fsdp", "tp"), mesh) == (Replicate(), Shard(1), Shard(2), Replicate())
        assert psharding.placements((("dp", "fsdp"),), mesh) == (Shard(0), Shard(0), Replicate(), Replicate())
        w = torch.randn(2, 4, 6)
        d = psharding.shard_params({"layers": {"wq": w}}, mesh)["layers"]["wq"]
        got = psharding.full(d)
        assert type(got) is torch.Tensor and torch.equal(got, w)
        with pytest.raises(ValueError, match=r"mesh \(2, 1, 1, 1\) needs 2 devices, have 1"):
            pbuild_mesh(pconfig.MeshConfig(dp=2))


# ---------------------------------------------------------------------------
# the checks the ranks ran
# ---------------------------------------------------------------------------


def test_pipeline_matches_jax_forward_and_grads(ranks):
    refs, res = ranks
    ref = refs["pipeline"]
    for r in res:
        got = r["pipeline"]
        for key, want in ref["fwd"].items():
            np.testing.assert_allclose(got["fwd"][key].numpy(), want, rtol=2e-5, atol=2e-5, err_msg=str(key))
        np.testing.assert_allclose(got["grads"]["h"].numpy(), ref["grads"]["h"], rtol=3e-5, atol=3e-5)
        for k, want in ref["grads"]["layers"].items():
            np.testing.assert_allclose(got["grads"]["layers"][k].numpy(), want, rtol=3e-5, atol=3e-5, err_msg=k)
        np.testing.assert_allclose(got["forward_hidden"].numpy(), ref["forward_hidden"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["staged"].numpy(), ref["fwd"][(2, 2)], rtol=2e-5, atol=2e-5)


def test_pipeline_stage_sharding_and_divisibility_errors(ranks):
    _, res = ranks
    for r in res:
        got = r["pipeline"]
        assert got["staged_placement"] == "(Replicate(), Shard(dim=1), Shard(dim=2), Shard(dim=0))"
        assert got["staged_local_layers"] == PIPE_CFG.num_layers // 2
        assert got["errors"] == ["batch 4 not divisible by 3 microbatches", "3 layers not divisible by pp=2"]


@pytest.mark.parametrize("lora", [False, True])
def test_sharded_train_steps_match_jax(ranks, lora):
    refs, res = ranks
    ref, got = refs["train"][lora], res[0]["train"][lora]
    for s, (a, b) in enumerate(zip(got["metrics"], ref["metrics"])):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, err_msg=f"loss, step {s}")
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5, err_msg=f"grad_norm, step {s}")
    assert got["gradient_step"] == 2
    assert all(r["train"][lora]["metrics"] == got["metrics"] for r in res)  # the global batch's, on every rank
    assert got["placements"]["text/layers/wq"] == "(Replicate(), Shard(dim=1), Shard(dim=2), Shard(dim=0))"
    grads = {n: g.numpy() for n, g in got["grads"].items()}
    top = max(np.abs(g).max() for g in grads.values())
    stage = _train_stage(lora)
    changed = 0
    for name, want in ref["params"].items():
        p = got["params"]
        for k in name.split("/"):
            p = p[k]
        p, init = p.numpy(), ref["init"][name]
        noise = np.abs(grads[name]) <= 1e-8 * top
        np.testing.assert_allclose(p[~noise], want[~noise], atol=1e-5, rtol=1e-5, err_msg=name)
        for side in (p, want):
            assert np.abs(side - init)[noise].max(initial=0) <= 4 * stage.train.proj_lr, name
        changed += not np.array_equal(p, init)
    assert changed > 10


def test_a_checkpoint_restores_on_another_mesh_shape(ranks):
    _, res = ranks
    for r in res:
        got = r["train"]
        assert got["restore_exact"] and got["global_batch"]
        assert got["restored_placement"] == "(Replicate(), Shard(dim=1), Shard(dim=2), Replicate())"
        np.testing.assert_allclose(got["next_loss"][1], got["next_loss"][0], rtol=2e-5)


LIVE_BYTES_SLACK = 64 << 10  # DCP's and the collectives' small tensors


@pytest.mark.parametrize("mesh", list(INIT_MESHES))
@pytest.mark.parametrize("lora", [False, True])
def test_the_sharded_init_equals_one_process_init(ranks, mesh, lora):
    _, res = ranks
    got = res[0]["train"]["init"][(mesh, lora)]
    state, _ = ptrainer.init_train_state(torch.Generator().manual_seed(INIT_SEED), port(_train_stage(lora)),
                                         dtype="float32")
    want = flat({"params": state.params, "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]})
    have = flat(got["state"])
    assert list(have) == list(want)
    assert [n for n in want if not torch.equal(have[n], want[n])] == []
    assert all(r["train"]["init"][(mesh, lora)]["local_zeros"] for r in res)  # the moments: local zeros
    wq = "(Replicate(), Shard(dim=1), Shard(dim=2), %s)" % ("Shard(dim=0)" if mesh == "dp2_tp2_pp2" else "Replicate()")
    assert got["placements"]["text/layers/wq"] == wq
    assert ("text/layers/lora/wq/A" in got["placements"]) == lora


def test_a_save_writes_each_ranks_own_chunks_once(ranks):
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    _, res = ranks
    md = FileSystemReader(res[0]["train"]["ckpt_dir"]).read_metadata()
    held = [r["train"]["held_chunks"] for r in res]
    assert set(md.state_dict_metadata) == {name for name, _ in held[0]}  # every leaf named, once
    for name, meta in md.state_dict_metadata.items():
        if isinstance(meta, TensorStorageMetadata):  # the chunks tile the leaf: every element stored once
            assert len({tuple(c.offsets) for c in meta.chunks}) == len(meta.chunks), name
            assert sum(int(np.prod(c.sizes)) for c in meta.chunks) == int(np.prod(meta.size)), name
    writers = set()
    for index, info in md.storage_data.items():
        rank = int(info.relative_path.split("_")[2])  # "__<rank>_0.distcp"
        offsets = None if index.offset is None else tuple(index.offset)
        assert (index.fqn, offsets) in held[rank], (index.fqn, offsets, rank)
        writers.add(rank)
    assert len(writers) > 1
    assert len(md.storage_data) == sum(len(m.chunks) if isinstance(m, TensorStorageMetadata) else 1
                                       for m in md.state_dict_metadata.values())


def test_one_process_reads_the_sharded_checkpoint_whole(ranks):
    _, res = ranks
    path = Path(res[0]["train"]["ckpt_dir"])
    want = res[0]["train"]["saved"]
    assert not torch.distributed.is_initialized()
    state = pckpt.restore(path, "cpu")
    got = flat({"params": state.params, **{k: state.opt_state[k] for k in ("mu", "nu", "acc")}})
    assert list(got) == list(want) and [n for n in want if not torch.equal(got[n], want[n])] == []
    assert state.opt_state["gradient_step"] == 2
    params = flat({"params": pqa.load_model(port(_train_stage(True)), str(path.parent), device="cpu")})
    assert list(params) == [n for n in want if n.startswith("params/")]
    assert all(torch.equal(params[n], want[n]) for n in params)


@pytest.mark.parametrize("phase", ["init", "save", "restore"])
def test_a_ranks_peak_live_bytes_stay_within_its_share_plus_the_largest_leaf(ranks, phase):
    _, res = ranks
    for r in res:
        t = r["train"]
        for case in (list(t["init"].values()) if phase == "init" else [t[f"{phase}_bytes"]]):
            assert case["share"] < case["total"]  # the state is sharded: a rank holds less than all of it
            assert case["share"] <= case["peak"] <= case["share"] + case["largest"] + LIVE_BYTES_SLACK, case


def test_ring_loss_grads_and_trainer_step_match_jax(ranks):
    refs, res = ranks
    ref = refs["ring"]
    for r in res:
        got = r["ring"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5, atol=2e-6)
        for name, want in ref["grads"].items():
            g = got["grads"][name]
            if g is None:  # a leaf the loss does not reach (no geom tokens): JAX's gradient is 0
                assert not want.any(), name
                continue
            np.testing.assert_allclose(g.numpy(), want, rtol=5e-4, atol=1e-5, err_msg=name)
        assert any(got["grads"][n] is not None for n in got["grads"] if n.startswith("vision/global_blocks/"))
        for ring, loss in got["step_losses"].items():  # the loss of the params before the update
            np.testing.assert_allclose(loss, ref["loss"], rtol=2e-5, err_msg=str(ring))
        assert got["extent_error"] == ("ring axis 'pp' has extent < 2 on mesh "
                                       "{'dp': 1, 'fsdp': 2, 'tp': 4, 'pp': 1}")


def test_ring_axis_without_a_mesh_raises():
    stage = port(jconfig.StageConfig(model=RING_CFG, data=jconfig.DataConfig(), train=jconfig.TrainConfig()))
    with pytest.raises(ValueError, match="ring_axis requires"):
        ptrainer.make_train_step(stage, None, image_token_id=500, has_geom=False, ring_axis="fsdp")


def test_generation_with_sharded_params_matches_jax(ranks):
    refs, res = ranks
    ref = refs["infer"]
    for r in res:
        got = r["infer"]
        assert got["wq_placement"] == "(Replicate(), Shard(dim=1), Shard(dim=2), Replicate())"
        assert got["w8_placement"] == got["wq_placement"]
        assert np.asarray(got["text"][0]).tolist() == ref["text"].tolist()
        assert np.asarray(got["w8"][0]).tolist() == ref["w8"].tolist()
        assert [np.asarray(x).tolist() for x in got["spec"]] == [x.tolist() for x in ref["spec"]]
        toks, lens, steps = got["early"]
        want_toks, want_lens, want_steps = ref["early"]
        assert np.asarray(toks)[0, :6].tolist() == want_toks[0, :6].tolist()
        assert np.asarray(toks)[1, :4].tolist() == want_toks[1, :4].tolist()
        assert np.asarray(lens).tolist() == want_lens.tolist() == [6, 4] and steps == want_steps == 6


# ---------------------------------------------------------------------------
# the sft CLI across processes
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sft_args(cfg, out, *extra):
    return ["--config", str(cfg), "--output_dir", str(out), "--tiny", "--mock_vision", "--device", "cpu",
            "--data_root", str(REPO), "--max_steps", "4", "--log_every_steps", "1", *extra]


def _losses(out_dir):
    return {rec["step"]: rec["loss"] for rec in map(json.loads, (Path(out_dir) / "metrics.jsonl").read_text().splitlines())}


def test_sft_cli_over_2_and_4_ranks_matches_one_process(tmp_path):
    toy = REPO / "configs" / "toy.yaml"
    one = tmp_path / "toy_batch4.yaml"  # the same global batch (4 rows) in one process
    one.write_text(toy.read_text().replace("batch_size_per_gpu: 2", "batch_size_per_gpu: 4"))
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    runs = {"fsdp2": (2, ["--fsdp", "2", "--save_every_steps", "2"]), "fsdp2_tp2": (4, ["--fsdp", "2", "--tp", "2"])}
    procs = {}
    for name, (n, flags) in runs.items():
        port_ = _free_port()
        procs[name] = [subprocess.Popen(
            [sys.executable, "-m", "vggt_qwen3_tpu_torch.train.sft",
             *_sft_args(toy, tmp_path / name, *flags, "--multihost", "--coordinator_address", f"127.0.0.1:{port_}",
                        "--num_processes", str(n), "--process_id", str(r))],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        sft.main(_sft_args(one, tmp_path / "one", "--save_every_steps", "100"))
        logs = {name: [p.communicate(timeout=300)[0] for p in ps] for name, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for name, ps in procs.items():
        assert all(p.returncode == 0 for p in ps), "\n".join(log[-3000:] for log in logs[name])
        assert "training: mesh dp=1 fsdp=2 tp=%d pp=1" % (2 if "tp2" in name else 1) in logs[name][0]
        assert not any("training: mesh" in log for log in logs[name][1:])  # only rank 0 prints
    ref = _losses(tmp_path / "one")
    assert sorted(ref) == [0, 1, 2, 3]
    for name in runs:
        got = _losses(tmp_path / name)
        assert sorted(got) == sorted(ref)
        for step in ref:
            np.testing.assert_allclose(got[step], ref[step], rtol=2e-5, err_msg=f"{name} step {step}")

    # the 2-rank run's step-2 checkpoint, resumed in one process
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    shutil.copytree(tmp_path / "fsdp2" / "step_2", resumed / "step_2")
    sft.main(_sft_args(one, resumed, "--save_every_steps", "100", "--resume"))
    got = _losses(resumed)
    assert sorted(got) == [2, 3]
    for step in got:
        np.testing.assert_allclose(got[step], ref[step], rtol=2e-5, err_msg=f"resumed step {step}")
