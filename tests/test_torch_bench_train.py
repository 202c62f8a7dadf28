"""The port's bench train mode (``python -m vggt_qwen3_tpu_torch.bench --mode
train``) on the CPU: the CLI at ``--tiny``, and its micro step held to JAX.

The JAX-vs-port check runs the stage-1 recipe (``configs/stage1_3d.yaml``:
LoRA r16 on qkvo, text layers 0–3 frozen) at tiny width in bf16 with the
frozen weights quantized as the train mode quantizes them: JAX's tree (the
tiny presets, a 2-layer Perceiver with dropout 0) gets LoRA, its tower
``quantize_vision("w8a8")`` and its Qwen3 base ``quantize_params("w8")`` with
the adapters re-attached; ``utils.from_jax`` carries that tree over. The
port's ``bench.train_micro`` (gradients for the trainable leaves only) and
JAX's ``vlm.train_forward`` under ``value_and_grad`` of the projector, the
geom head and the adapters see the bench's seeded batch. JAX's VGGT
attentions run its Pallas flash kernel in interpret mode. Tolerances are
bf16's (every intermediate rounded to bf16, in other orders; XLA's CPU
backend also keeps f32 inside its fusions): the loss within 1e-2 relative,
each trainable leaf's gradient within 5e-2 of the larger of its norm and 1e-2
of the largest leaf's norm (‖Δ‖₂ ≤ 5e-2·max(‖ref‖₂, 1e-2·top): the
Perceiver's key bias has a zero gradient in exact arithmetic and the adapters'
scale leaves small ones, sums of many bf16 terms), and the whole gradient
within 3e-2 (measured: 0.5–1.2 % a leaf, 8.9 % for a scale leaf).
"""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vggt_qwen3_tpu import config as jconfig
from vggt_qwen3_tpu.models import qwen3 as jqwen3
from vggt_qwen3_tpu.models import vlm as jvlm
from vggt_qwen3_tpu.ops import attention as jattention
from vggt_qwen3_tpu.ops import flash_attention as jflash
from vggt_qwen3_tpu_torch import bench
from vggt_qwen3_tpu_torch import config as pconfig
from vggt_qwen3_tpu_torch.ops import decode_matmul
from vggt_qwen3_tpu_torch.train import trainer
from vggt_qwen3_tpu_torch.utils.from_jax import params_from_jax

REPO = Path(__file__).resolve().parents[1]


def test_train_mode_cli_runs_tiny_on_the_cpu_and_prints_its_json_line():
    proc = subprocess.run([sys.executable, "-m", "vggt_qwen3_tpu_torch.bench", "--mode", "train", "--tiny",
                           "--device", "cpu", "--cycle", "2", "--phases"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["mode"] == "train" and last["device"] == "cpu" and last["opt"] == "adam8bit"
    assert (last["batch"], last["views"], last["cycle"], last["accum"]) == (2, 2, 2, 32)
    assert last["mfu"] is None and last["card"] is None  # no device figure from a CPU run
    assert last["step_s"] == pytest.approx(32 * last["micro_s"] + max(last["update_residual_s"], 0.0))
    assert all(np.isfinite(last["losses"])) and last["vision_s"] > 0 and last["trainable_params"] > 0


def test_train_mode_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.train_setup(bench.parse_args(["--mode", "train"]))
    assert bench.parse_args(["--mode", "train", "--tiny"]).device == "cpu"


@pytest.fixture
def jax_vggt_flash(monkeypatch):
    """Route JAX's VGGT attentions through its Pallas flash kernel (interpret mode)."""
    jax.clear_caches()
    monkeypatch.setattr(jattention, "flash_eligible", lambda *a: True)
    monkeypatch.setattr(jflash, "flash_attention", functools.partial(jflash.flash_attention, interpret=True))
    yield
    jax.clear_caches()


def _reduce(cfg, stage):
    return dataclasses.replace(stage, model=dataclasses.replace(
        stage.model, num_vis_tokens=16, dtype="bfloat16",
        projector=cfg.PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128,
                                      dropout=0.0)))


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_quantized_frozen_micro_step_matches_jax_value_and_grad(jax_vggt_flash):
    yaml = REPO / "configs" / "stage1_3d.yaml"
    jstage = _reduce(jconfig, jconfig.load_stage_config(yaml, text_config=jconfig.QWEN3_TINY,
                                                        vision_config=jconfig.VGGT_TINY))
    pstage = _reduce(pconfig, pconfig.load_stage_config(yaml, text_config=pconfig.QWEN3_TINY,
                                                        vision_config=pconfig.VGGT_TINY))
    key = jax.random.PRNGKey(0)
    jp = jvlm.init_params(key, jstage.model, dtype="bfloat16")
    jp["text"] = jqwen3.add_lora(jp["text"], jstage.model.text, jstage.lora, jax.random.fold_in(key, 7))
    jp = jvlm.quantize_vision(jp, mode="w8a8", donate=False)
    lora = jp["text"]["layers"]["lora"]
    jp["text"] = jqwen3.quantize_params(jp["text"], mode="w8", donate=False)
    jp["text"]["layers"] = dict(jp["text"]["layers"], lora=lora)
    # the adapters' B starts at 0: give it values, so the gradients through A are not 0
    rng = np.random.default_rng(1)
    for ad in lora.values():
        ad["B"] = jnp.asarray(rng.standard_normal(ad["B"].shape) * 0.02, jnp.bfloat16)
    jp["text"]["layers"]["lora"] = lora

    params = params_from_jax(jax.tree.map(np.asarray, jp))
    assert params["vision"]["frame_blocks"]["qkv_w"]["w8"].dtype == torch.int8
    assert "a8" in params["vision"]["frame_blocks"]["qkv_w"] and isinstance(params["text"]["embed"], dict)
    args = bench.parse_args(["--mode", "train", "--tiny", "--device", "cpu", "--cycle", "2"])
    s = bench.train_setup(args, stage=pstage, params=params)
    assert set(s.trainable) == {n for n in _flat(params) if n.startswith(("projector/", "geom/", "text/layers/lora/"))}
    before = dict(decode_matmul.launches)
    loss, grads = bench.train_micro(s)
    assert dict(decode_matmul.launches) == before  # a W8 base at S = 64 never reaches the fused W8 wrappers
    assert all(not t.requires_grad for _, t in trainer.named_leaves(s.params))

    b = s.batch
    jb = {k: _to_jax(v) for k, v in b.items() if k != "geom_token"}
    jgeom = {k: _to_jax(v) for k, v in b["geom_token"].items()}
    train_names = list(s.trainable)

    def jloss(trainable):
        text = dict(jp["text"], layers=dict(jp["text"]["layers"], lora=trainable["lora"]))
        p = dict(jp, projector=trainable["projector"], geom=trainable["geom"], text=text)
        return jvlm.train_forward(p, jstage.model, images=jb["pixel_values"], geom_token=jgeom,
                                  input_ids=jb["input_ids"], attention_mask=jb["attention_mask"],
                                  labels=jb["labels"], image_token_id=s.img_id)

    trainable = {"projector": jp["projector"], "geom": jp["geom"], "lora": jp["text"]["layers"]["lora"]}
    jl, jg = jax.jit(jax.value_and_grad(jloss))(trainable)
    jg = _flat(jax.tree.map(lambda x: np.asarray(x, np.float32), jg))
    jg = {("text/layers/" + n if n.startswith("lora/") else n): g for n, g in jg.items()}
    assert set(jg) == set(train_names)
    assert abs(float(loss) - float(jl)) <= 1e-2 * abs(float(jl))
    num = den = 0.0
    top = max(np.linalg.norm(g) for g in jg.values())
    for name in train_names:
        got, ref = grads[name].float().numpy(), jg[name]
        assert got.shape == ref.shape, name
        err, norm = np.linalg.norm(got - ref), np.linalg.norm(ref)
        # a leaf whose gradient is 0 in exact arithmetic (the Perceiver's key bias) or small (an adapter's
        # scale, a sum over many elements) holds rounding noise: held against 1e-2 of the largest norm
        assert err <= 5e-2 * max(norm, 1e-2 * top), (name, err / norm)
        num, den = num + err ** 2, den + norm ** 2
    assert (num / den) ** 0.5 <= 3e-2


def test_chip_smoke_recipe_stages_are_the_yamls_with_their_listed_reductions():
    """The phase "training recipes" of ``chip_smoke.py`` trains the two
    shipped recipes, built from the presets, reduced only as listed: the
    stage-1 recipe's schedule horizon (4 updates for 30,000); stage 2's rows
    (2 for 4) and grad_accum (2 for 64)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    s1 = pconfig.load_stage_config(REPO / "configs" / "stage1_3d.yaml")
    built = chip_smoke.recipe_stage()
    assert (built.model, built.data, built.lora, built.freeze_text_layers) == \
        (s1.model, s1.data, s1.lora, s1.freeze_text_layers)
    assert dataclasses.replace(built.train, max_steps=30_000) == s1.train
    s2 = pconfig.load_stage_config(REPO / "configs" / "stage2_arkit.yaml")
    built = chip_smoke.stage2_train_stage()
    assert (built.model, built.data, built.lora, built.freeze_text_layers) == \
        (s2.model, s2.data, s2.lora, s2.freeze_text_layers)
    assert dataclasses.replace(built.train, batch_size_per_device=4, grad_accum=64) == s2.train
