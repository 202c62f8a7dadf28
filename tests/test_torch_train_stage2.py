"""The stage-2 recipe (``configs/stage2_arkit.yaml``) through the port's
trainer against the JAX package's, in float32 on the CPU.

The stage is the YAML's, loaded on each side by its own ``load_stage_config``
with the tiny presets (QWEN3_TINY, VGGT_TINY): LoRA r32 on q/v/o only (the
fused QKV group sees adapters on two of its three projections), text layers
0–1 frozen, 10 views, view dropout 0.2, the ARKit ``.json`` array split.
Reduced as the CLI's ``--tiny`` reduces it (16 vision tokens, 2 geom tokens,
a 2-layer Perceiver, 56² views, ``max_length`` 256), with the Perceiver's
dropout at 0 (its random streams differ) and 2 rows a micro step at
grad_accum 2 (the recipe has 4 and 64). The placeholder ARKit records go
through each side's own reader, collator and loader (the port's lazy reader
and native image decoder; JAX's with its own); both draw the same kept views
under view dropout, so their batches are bit-identical and are compared
before the steps. JAX's VGGT attentions run its Pallas flash kernel in
interpret mode. Held to the tolerances of ``tests/test_torch_train_slice.py``:
loss and ``grad_norm`` at each of 4 micro steps rtol 1e-5, the parameters
after 2 updates 1e-5 (elements whose first-step gradient is 0 in exact
arithmetic to the step's size), frozen leaves bit-identical.
"""

import dataclasses
import functools
from pathlib import Path

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
from vggt_qwen3_tpu_torch.data import image_decode
from vggt_qwen3_tpu_torch.data.tokenizer import IMAGE_TOKEN, load_tokenizer
from vggt_qwen3_tpu_torch.train import sft as psft
from vggt_qwen3_tpu_torch.train import trainer as ptrainer
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "configs" / "stage2_arkit.yaml"


@pytest.fixture
def jax_vggt_flash(monkeypatch):
    """Route JAX's VGGT attentions through its Pallas flash kernel (interpret mode)."""
    jax.clear_caches()
    monkeypatch.setattr(jattention, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jflash, "flash_attention", functools.partial(jflash.flash_attention, interpret=True))
    yield
    jax.clear_caches()


def _reduce(cfg, stage):
    return dataclasses.replace(
        stage,
        model=dataclasses.replace(
            stage.model, num_vis_tokens=16, geom_tokens=2, dtype="float32",
            projector=cfg.PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128,
                                          dropout=0.0)),
        data=dataclasses.replace(stage.data, image_size=cfg.VGGT_TINY.img_size, max_length=256),
        train=dataclasses.replace(stage.train, batch_size_per_device=2, grad_accum=2, max_steps=8))


def _stages():
    jstage = _reduce(jconfig, jconfig.load_stage_config(
        YAML, text_config=dataclasses.replace(jconfig.QWEN3_TINY, dtype="float32"),
        vision_config=jconfig.VGGT_TINY))
    pstage = _reduce(pconfig, pconfig.load_stage_config(
        YAML, text_config=dataclasses.replace(pconfig.QWEN3_TINY, dtype="float32"),
        vision_config=pconfig.VGGT_TINY))
    return jstage, pstage


def test_stage2_yaml_is_what_the_test_trains():
    _, pstage = _stages()
    assert pstage.lora.enable and pstage.lora.rank == 32
    assert pstage.lora.target_modules == ("q_proj", "v_proj", "o_proj")
    assert pstage.freeze_text_layers == (0, 1) and pstage.model.freeze_vision
    assert (pstage.data.num_views, pstage.data.view_dropout) == (10, 0.2)
    assert pstage.data.datasets == {"arkit_synth": "data/processed/arkit_synth/*.json"}


def _jax_loader(stage, tok):
    datasets = {name: jdataset.MultiViewJsonDataset(jdataset.DatasetConfig(
        path_glob=g, num_views=stage.data.num_views, image_size=stage.data.image_size, task=name, root=str(REPO)))
        for name, g in stage.data.datasets.items()}
    collator = jcollator.MultiViewCollator(
        stage.data.image_size, tok, stage.data.max_length, num_vis_tokens=stage.model.num_vis_tokens,
        geom_tokens=stage.model.geom_tokens, view_dropout=stage.data.view_dropout, seed=stage.train.seed,
        pad_to=max(stage.data.max_length, stage.model.num_vis_tokens + stage.model.geom_tokens + 64),
        emit_geom=stage.model.geom_tokens > 0)
    return jcollator.data_loader(jdataset.MultiSourceDataset(datasets, stage.data.mix_ratio), collator,
                                 stage.train.batch_size_per_device, shuffle=True, seed=stage.train.seed)


def _to_torch(b):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items() if k != "geom_token"}
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


def test_stage2_train_steps_match_jax(jax_vggt_flash):
    jstage, pstage = _stages()
    tok = load_tokenizer(None)
    img_id = tok.convert_tokens_to_ids(IMAGE_TOKEN)
    before = dict(image_decode.decoded)
    ploader = psft.build_data(pstage, tok, data_root=str(REPO))
    batches = [next(ploader) for _ in range(4)]
    assert image_decode.decoded["native"] > before["native"]  # the port's native decoder read the views
    jloader = _jax_loader(jstage, tok)
    dropped = 0
    for b in batches:
        ref = next(jloader)
        assert b.keys() == ref.keys()
        for key in b:
            if key == "geom_token":
                for g in b[key]:
                    np.testing.assert_array_equal(b[key][g], ref[key][g], err_msg=g)
            else:
                np.testing.assert_array_equal(b[key], ref[key], err_msg=key)
        pv = b["pixel_values"]
        dropped += sum(not np.array_equal(pv[r, v], pv[r, v - 1]) for r in range(pv.shape[0]) for v in range(1, 10))
    assert b["pixel_values"].shape[1] == 10 and dropped > 0

    jstate, jtx = jtrainer.init_train_state(jax.random.PRNGKey(0), jstage, dtype="float32")
    assert set(jstate.params["text"]["layers"]["lora"]) == {"wq", "wv", "wo"}
    init = _flat(jax.tree.map(np.asarray, jstate.params))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    ptx = ptrainer.make_tx(pstage, params)
    pstate = ptrainer.TrainState(params=params, opt_state=ptx.init(params), step=0)

    b0 = _to_jax(batches[0])

    def jloss(p):
        return jvlm.train_forward(p, jstage.model, images=b0["pixel_values"], geom_token=b0["geom_token"],
                                  input_ids=b0["input_ids"], attention_mask=b0["attention_mask"],
                                  labels=b0["labels"], image_token_id=img_id)

    jg = _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(jstate.params)))
    top = max(np.abs(g).max() for g in jg.values())

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
        # the tower, the text base and (layers 0-1 frozen: all of the tiny model's) the adapters
        if name.startswith(("vision/", "text/")):
            np.testing.assert_array_equal(got, init[name], err_msg=name)
            np.testing.assert_array_equal(jp[name], init[name], err_msg=name)
            continue
        noise = np.abs(jg[name]) <= 1e-8 * top
        np.testing.assert_allclose(got[~noise], jp[name][~noise], atol=1e-5, rtol=1e-5, err_msg=name)
        for side in (got, jp[name]):
            assert np.abs(side - init[name])[noise].max(initial=0) <= 4 * pstage.train.proj_lr, name
        changed += not np.array_equal(got, init[name])
    assert changed > 10
