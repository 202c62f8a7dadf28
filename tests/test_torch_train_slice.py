"""The port's training slice against the JAX package's, in float32 on the CPU.

A tiny stage (QWEN3_TINY, VGGT_TINY, a 2-layer Perceiver with dropout 0,
geom tokens, LoRA r4 on qkvo, layer 0 frozen) gets the same weights on both
sides (JAX ``init_train_state`` → numpy → ``params_from_jax``) and the same
collated batches. JAX's VGGT attentions go through its Pallas flash kernel in
interpret mode — forward and the dq / dk-dv backward kernels — as the TPU
runs them (``flash_eligible`` patched to True); the port's go through its
plain versions, which the CUDA kernels are held to on the card.

Tolerances (float32; sums in other orders): loss and ``grad_norm`` rtol 1e-5;
per-leaf gradients 1e-4 relative to the leaf's largest gradient (floored at
1e-4 of the tree's largest: a leaf whose gradient is 0 in exact arithmetic,
such as the Perceiver's key bias under the softmax, holds rounding noise
only); parameters after 2 updates 1e-5 (atol and rtol), except elements whose gradient is 0 in
exact arithmetic (Adam turns their rounding noise into a step of either
sign: they are held to the step's size); frozen leaves bit-identical. Schedules,
collated batches and the fast-forwarded loader stream are compared exactly
(views at the collator's image size, so no resize rounding enters).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.data import collator as jcollator
from vggt_qwen3_tpu.data import dataset as jdataset
from vggt_qwen3_tpu.models import vlm as jvlm
from vggt_qwen3_tpu.ops import attention as jattention
from vggt_qwen3_tpu.ops import flash_attention as jflash
from vggt_qwen3_tpu.train import trainer as jtrainer
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.data import collator as pcollator
from vggt_qwen3_tpu_torch.data import dataset as pdataset
from vggt_qwen3_tpu_torch.data.tokenizer import IMAGE_TOKEN, load_tokenizer
from vggt_qwen3_tpu_torch.models import vlm as pvlm
from vggt_qwen3_tpu_torch.train import trainer as ptrainer
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

IMG = jconfig.VGGT_TINY.img_size  # 56: the views need no resize


@pytest.fixture
def jax_vggt_flash(monkeypatch):
    """Route JAX's VGGT attentions through its Pallas flash kernel (interpret mode)."""
    jax.clear_caches()
    monkeypatch.setattr(jattention, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jflash, "flash_attention", functools.partial(jflash.flash_attention, interpret=True))
    yield
    jax.clear_caches()


def _stages(freeze_vision: bool):
    model = jconfig.VLMConfig(
        text=dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32"),
        vision=jconfig.VGGT_TINY,
        projector=jconfig.PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128,
                                          dropout=0.0),
        num_vis_tokens=16, geom_tokens=2, freeze_vision=freeze_vision, dtype="float32",
    )
    jstage = jconfig.StageConfig(
        model=model,
        data=jconfig.DataConfig(num_views=2, image_size=IMG, max_length=64, view_dropout=0.3),
        train=jconfig.TrainConfig(lr=2e-3, proj_lr=1e-2, weight_decay=0.1, warmup_ratio=0.25, max_steps=8,
                                  grad_accum=2, gradient_clip=0.5, batch_size_per_device=2, seed=3),
        lora=jconfig.LoRAConfig(enable=True, rank=4, alpha=8),
        freeze_text_layers=(0,),
    )

    def port(obj):
        if dataclasses.is_dataclass(obj):
            cls = getattr(pconfig, type(obj).__name__)
            return cls(**{f.name: port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
        return obj

    return jstage, port(jstage)


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


def _collators(tok, **kw):
    return jcollator.MultiViewCollator(IMG, tok, **kw), pcollator.MultiViewCollator(IMG, tok, **kw)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if key == "geom_token":
            assert (a[key] is None) == (b[key] is None)
            if a[key] is not None:
                assert a[key].keys() == b[key].keys()
                for g in a[key]:
                    np.testing.assert_array_equal(a[key][g], b[key][g])
        else:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_collator_batches_bit_identical_to_jax():
    tok = load_tokenizer(None)
    recs = _records(5, 4, seed=0)
    jcol, pcol = _collators(tok, max_length=40, num_vis_tokens=8, geom_tokens=2, view_dropout=0.3, seed=7,
                            pad_to=None, emit_geom=None)
    for bi in (0, 3):
        _assert_batches_equal(jcol(recs, batch_index=bi), pcol(recs, batch_index=bi))
    # view dropout really moved views: some row's views are not the record's
    out = pcol(recs, batch_index=3)["pixel_values"]
    assert any(not np.array_equal(out[r, v], recs[r]["images"][v].transpose(2, 0, 1) / 255.0)
               for r in range(5) for v in range(1, 4))


class _ListDataset:
    def __init__(self, recs):
        self.recs = recs

    def __len__(self):
        return len(self.recs)

    def __getitem__(self, i):
        return self.recs[i]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_stream_and_fast_forward_bit_identical_to_jax(prefetch):
    tok = load_tokenizer(None)
    a, b = _records(5, 2, seed=1), _records(3, 2, seed=2)
    jcol, pcol = _collators(tok, max_length=40, num_vis_tokens=8, geom_tokens=2, view_dropout=0.3, seed=5,
                            pad_to=96, emit_geom=True)
    jms = jdataset.MultiSourceDataset({"a": _ListDataset(a), "b": _ListDataset(b)}, {"a": 0.7, "b": 0.3})
    pms = pdataset.MultiSourceDataset({"a": _ListDataset(a), "b": _ListDataset(b)}, {"a": 0.7, "b": 0.3})
    jl = jcollator.data_loader(jms, jcol, 3, seed=5, prefetch_batches=prefetch)
    pl = pcollator.data_loader(pms, pcol, 3, seed=5, prefetch_batches=prefetch)
    jstream = [next(jl) for _ in range(4)]
    for jb, pb in zip(jstream, [next(pl) for _ in range(4)]):
        _assert_batches_equal(jb, pb)
    pms2 = pdataset.MultiSourceDataset({"a": _ListDataset(a), "b": _ListDataset(b)}, {"a": 0.7, "b": 0.3})
    resumed = pcollator.data_loader(pms2, pcol, 3, seed=5, start_batches=2, prefetch_batches=prefetch)
    for jb in jstream[2:]:
        _assert_batches_equal(jb, next(resumed))


def test_schedules_equal_optax():
    _, pstage = _stages(True)
    for lr in (2e-3, 1e-2, 5e-6):
        for cfg in (pstage.train, dataclasses.replace(pstage.train, max_steps=30_000, warmup_ratio=0.03)):
            ref = jtrainer.cosine_schedule(lr, cfg)
            got = ptrainer.cosine_schedule(lr, cfg)
            counts = range(0, cfg.max_steps + 3) if cfg.max_steps < 100 else [0, 1, 450, 899, 900, 901, 15000, 29999]
            for c in counts:
                r = np.float32(ref(jnp.asarray(c, jnp.int32)))
                g = got(c)
                assert g.dtype == torch.float32 and np.float32(g.item()) == r, (lr, c, g.item(), r)


def _batch_np(tok, pstage, step):
    recs = _records(2, 2, seed=10 + step)
    col = pcollator.MultiViewCollator(IMG, tok, 64, num_vis_tokens=16, geom_tokens=2, view_dropout=0.3,
                                      seed=3, pad_to=96, emit_geom=True)
    return col(recs, batch_index=step)


def _to_torch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items() if k != "geom_token"}
    out["geom_token"] = {k: torch.from_numpy(v) for k, v in b["geom_token"].items() if k != "mask"}
    return out


def _to_jax(b):
    out = {k: jnp.asarray(v) for k, v in b.items() if k != "geom_token"}
    out["geom_token"] = {k: jnp.asarray(v) for k, v in b["geom_token"].items() if k != "mask"}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("freeze_vision", [True, False])
def test_train_steps_match_jax(freeze_vision, jax_vggt_flash):
    jstage, pstage = _stages(freeze_vision)
    tok = load_tokenizer(None)
    img_id = tok.convert_tokens_to_ids(IMAGE_TOKEN)
    jstate, jtx = jtrainer.init_train_state(jax.random.PRNGKey(0), jstage, dtype="float32")
    init = _flat(jax.tree.map(np.asarray, jstate.params))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    ptx = ptrainer.make_tx(pstage, params)
    pstate = ptrainer.TrainState(params=params, opt_state=ptx.init(params), step=0)
    batches = [_batch_np(tok, pstage, s) for s in range(4)]

    # per-leaf gradients of the first micro step
    b0 = _to_jax(batches[0])

    def jloss(p):
        return jvlm.train_forward(p, jstage.model, images=b0["pixel_values"], geom_token=b0["geom_token"],
                                  input_ids=b0["input_ids"], attention_mask=b0["attention_mask"],
                                  labels=b0["labels"], image_token_id=img_id)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jstate.params)
    jg = _flat(jax.tree.map(np.asarray, jg))
    leaves = dict(ptrainer.named_leaves(pstate.params))
    for p in leaves.values():
        p.requires_grad_(True)
    tb = _to_torch(batches[0])
    loss = pvlm.train_forward(pstate.params, pstage.model, images=tb["pixel_values"],
                              geom_token=tb["geom_token"], input_ids=tb["input_ids"],
                              attention_mask=tb["attention_mask"], labels=tb["labels"], image_token_id=img_id)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    top = max(np.abs(g).max() for g in jg.values())
    for name, p in leaves.items():
        got = np.zeros_like(jg[name]) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(jg[name]).max(), 1e-4 * top)
        np.testing.assert_allclose(got, jg[name], atol=1e-4 * scale, rtol=0, err_msg=name)
        if freeze_vision and name.startswith("vision/"):
            assert p.grad is None and not jg[name].any(), name
        p.grad = None
        p.requires_grad_(False)
    assert freeze_vision or any(np.abs(jg[n]).max() > 0 for n in jg if n.startswith("vision/frame_blocks/qkv_w"))

    # four micro steps of each make_train_step: two updates at grad_accum 2
    jstep = jtrainer.make_train_step(jstage, jtx, img_id, has_geom=True)
    pstep = ptrainer.make_train_step(pstage, ptx, img_id, has_geom=True)
    for s, b in enumerate(batches):
        jstate, jm = jstep(jstate, _to_jax(b), jax.random.PRNGKey(s))
        pstate, pm = pstep(pstate, _to_torch(b), None)
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-5, err_msg=f"loss, step {s}")
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"grad_norm, step {s}")
    assert pstate.step == 4 and pstate.opt_state["gradient_step"] == 2
    jp = _flat(jax.tree.map(np.asarray, jstate.params))
    changed = 0
    for name, p in ptrainer.named_leaves(pstate.params):
        got = p.numpy()
        frozen = (name.startswith("text/") and "/lora/" not in name) or (freeze_vision and name.startswith("vision/"))
        if frozen:
            np.testing.assert_array_equal(got, init[name], err_msg=name)
            np.testing.assert_array_equal(jp[name], init[name], err_msg=name)
            continue
        if "/lora/" in name:  # layer 0 frozen: bit-identical
            np.testing.assert_array_equal(got[0], init[name][0], err_msg=name)
        # an element whose gradient is 0 in exact arithmetic (the Perceiver's key
        # bias) holds rounding noise, which Adam scales to a step of either sign
        noise = np.abs(jg[name]) <= 1e-8 * top
        np.testing.assert_allclose(got[~noise], jp[name][~noise], atol=1e-5, rtol=1e-5, err_msg=name)
        for side in (got, jp[name]):
            assert np.abs(side - init[name])[noise].max(initial=0) <= 4 * pstage.train.proj_lr, name
        changed += not np.array_equal(got, init[name])
    assert changed > 10


def test_lm_head_gradient_multiplies_the_f32_cotangent_as_jax_in_bf16():
    """The tied LM head's gradients in bf16 (the full-width path's dtype)
    against ``jax.vjp`` of JAX's ``lm_logits``, whose transpose multiplies the
    f32 cotangent in f32: the same bf16 values but for at most 1 % of elements,
    each within one bf16 step (f32 sums in another order cross a rounding
    boundary). A cotangent rounded to bf16 first differs in ~40 %."""
    from vggt_qwen3_tpu.models import qwen3 as jqwen3
    from vggt_qwen3_tpu_torch.models import qwen3 as pqwen3

    from tests.test_torch_models import port_cfg

    cfg = dataclasses.replace(jconfig.QWEN3_TINY, dtype="bfloat16")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, cfg.hidden_size)).astype(jnp.bfloat16)
    e = (rng.standard_normal((cfg.vocab_size, cfg.hidden_size)) * 0.02).astype(jnp.bfloat16)
    g = rng.standard_normal((2, 8, cfg.vocab_size)).astype(np.float32)
    _, vjp = jax.vjp(lambda h, w: jqwen3.lm_logits({"embed": w}, cfg, h), jnp.asarray(x), jnp.asarray(e))
    ref = vjp(jnp.asarray(g))
    xt, et = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).requires_grad_() for a in (x, e))
    pqwen3.lm_logits({"embed": et}, port_cfg(cfg), xt).backward(torch.from_numpy(g))
    for name, got, want in (("hidden", xt.grad, ref[0]), ("embed", et.grad, ref[1])):
        assert got.dtype == torch.bfloat16, name
        got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
        assert (got != want).mean() <= 1e-2, name
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0, err_msg=name)
