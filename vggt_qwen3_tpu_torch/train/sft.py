"""SFT training CLI on one card (counterpart of ``vggt_qwen3_tpu/train/sft.py``).

    python -m vggt_qwen3_tpu_torch.train.sft --config configs/stage1_3d.yaml \\
        --output_dir ckpts/stage1 [--max_steps N] [--stop_at_step N] [--resume] \\
        [--tiny] [--mock_vision] [--data_root DIR] [--seed N] [--device cuda]

The stage YAML's model, data and train blocks as the JAX CLI reads them;
``--tiny`` swaps in the tiny models (float32, 2 views at the tiny tower's
image size), ``--mock_vision`` zero vision tokens. One micro step per batch
of ``batch_size_per_device`` rows; an update every ``grad_accum`` micro steps
(``max_steps`` counts micro steps, as in JAX). Checkpoints go to
``<output_dir>/step_<n>/`` every ``save_every_steps`` and at the end;
``--resume`` continues from the newest one: the loader fast-forwards to the
step's batch and each micro step's dropout generator is a pure function of
``(seed + 1, step)``, so a resumed run reproduces an uninterrupted one. A run
into an ``output_dir`` that already holds a ``step_<n>/`` needs ``--resume``.

The mesh flags of the JAX CLI (``--dp/--fsdp/--tp/--pp/--pp_microbatches/
--ring/--multihost``) raise ``NotImplementedError``: parallelism is a later
slice of the port (ROADMAP: parallelism). The YAML's ``mesh:`` block is not
read.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..config import QWEN3_TINY, VGGT_TINY, PerceiverConfig, StageConfig, load_stage_config
from ..data.collator import MultiViewCollator, data_loader
from ..data.dataset import DatasetConfig, MultiSourceDataset, MultiViewJsonDataset
from ..data.tokenizer import IMAGE_TOKEN, load_tokenizer
from ..utils.logging import MetricLogger
from . import checkpoint as ckpt
from . import trainer

PARALLEL_FLAGS = ("dp", "fsdp", "tp", "pp", "pp_microbatches", "ring", "multihost")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="VGGT-Qwen3 SFT trainer (PyTorch/CUDA port).")
    p.add_argument("--config", required=True, help="stage YAML (reference schema)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_steps", type=int, default=None, help="override YAML max_steps")
    p.add_argument("--mock_vision", action="store_true", help="zero-token vision backend")
    p.add_argument("--tiny", action="store_true", help="tiny model dims (smoke tests)")
    p.add_argument("--resume", action="store_true", help="resume from latest step_<n>/")
    p.add_argument("--data_root", default=None, help="base dir for relative data paths")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save_every_steps", type=int, default=None, help="override YAML")
    p.add_argument("--log_every_steps", type=int, default=None, help="override YAML")
    p.add_argument("--stop_at_step", type=int, default=None,
                   help="stop early without changing the lr-schedule horizon; resume continues to max_steps")
    p.add_argument("--device", default="cuda")
    for flag in ("dp", "fsdp", "tp", "pp", "pp_microbatches"):
        p.add_argument(f"--{flag}", type=int, default=None, help="not ported (ROADMAP: parallelism)")
    p.add_argument("--ring", nargs="?", const="fsdp", default=None, help="not ported (ROADMAP: parallelism)")
    p.add_argument("--multihost", action="store_true", help="not ported (ROADMAP: parallelism)")
    args = p.parse_args(argv)
    given = [f"--{f}" for f in PARALLEL_FLAGS if getattr(args, f) not in (None, False)]
    if given:
        raise NotImplementedError(
            f"{' '.join(given)}: meshes, sharding, pipelines, ring attention and multi-host runs are not "
            "ported yet (ROADMAP: parallelism); the port trains on one card")
    return args


def build_stage(args) -> StageConfig:
    stage = load_stage_config(args.config, text_config=QWEN3_TINY if args.tiny else None,
                              vision_config=VGGT_TINY if args.tiny else None)
    if args.tiny:
        stage = dataclasses.replace(
            stage,
            model=dataclasses.replace(
                stage.model,
                num_vis_tokens=min(stage.model.num_vis_tokens, 16),
                geom_tokens=min(stage.model.geom_tokens, 2),
                projector=PerceiverConfig(latent_dim=64, num_latents=min(stage.model.num_vis_tokens, 16),
                                          num_heads=4, num_layers=2, ffn_dim=128, dropout=0.1),
                dtype="float32",
            ),
            data=dataclasses.replace(stage.data, image_size=VGGT_TINY.img_size,
                                     num_views=min(stage.data.num_views, 2),
                                     max_length=min(stage.data.max_length, 256)),
        )
    if args.mock_vision:
        stage = dataclasses.replace(stage, model=dataclasses.replace(stage.model, vision=None,
                                                                     vision_backbone="mock"))
    train = stage.train
    for key in ("max_steps", "seed", "save_every_steps", "log_every_steps"):
        value = getattr(args, key)
        if value is not None and (key != "max_steps" or value):
            train = dataclasses.replace(train, **{key: value})
    return dataclasses.replace(stage, train=train)


def build_data(stage: StageConfig, tokenizer, *, data_root=None, start_batches: int = 0, datasets=None):
    """The JAX CLI's loader: the stage's datasets (read from their globs, or
    ``datasets``: name → any dataset of records) mixed by ratio, a fixed
    padded length, geom emitted iff the model has geom tokens."""
    if datasets is None:
        datasets = {name: MultiViewJsonDataset(DatasetConfig(
            path_glob=glob_path, num_views=stage.data.num_views, image_size=stage.data.image_size,
            task=name, root=data_root)) for name, glob_path in stage.data.datasets.items()}
    collator = MultiViewCollator(
        stage.data.image_size, tokenizer, stage.data.max_length,
        num_vis_tokens=stage.model.num_vis_tokens, geom_tokens=stage.model.geom_tokens,
        view_dropout=stage.data.view_dropout, seed=stage.train.seed,
        pad_to=max(stage.data.max_length, stage.model.num_vis_tokens + stage.model.geom_tokens + 64),
        emit_geom=stage.model.geom_tokens > 0,
    )
    return data_loader(MultiSourceDataset(datasets, stage.data.mix_ratio), collator,
                       stage.train.batch_size_per_device, shuffle=True, seed=stage.train.seed,
                       start_batches=start_batches)


def to_device(batch, dev):
    """A collated numpy batch → tensors on ``dev`` (the geom dict without its
    presence mask, or None)."""
    out = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()
           if k != "geom_token" and v is not None}
    geom = batch.get("geom_token")
    out["geom_token"] = None if geom is None else {
        k: torch.from_numpy(v).to(dev) for k, v in geom.items() if k != "mask"}
    return out


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    stage = build_stage(args)
    out_dir = Path(args.output_dir)
    found = ckpt.latest_step_dir(out_dir)
    if found is not None and not args.resume:  # a save into an existing step_<n>/ would fail mid-run
        raise FileExistsError(f"{out_dir} already holds checkpoints (newest {found.name}): pass --resume "
                              "to continue from it, or choose another --output_dir")
    out_dir.mkdir(parents=True, exist_ok=True)
    tokenizer = load_tokenizer(None if args.tiny else (stage.tokenizer_path or stage.text_model_name))
    image_token_id = tokenizer.convert_tokens_to_ids(IMAGE_TOKEN)

    resume_dir = found if args.resume else None
    if resume_dir is not None:
        state = ckpt.restore(resume_dir, dev)
        tx = trainer.make_tx(stage, state.params)
        print(f"resumed from {resume_dir} at step {state.step}", flush=True)
    else:
        state, tx = trainer.init_train_state(torch.Generator(device=dev).manual_seed(stage.train.seed), stage,
                                             dtype=stage.model.dtype)
    loader = build_data(stage, tokenizer, data_root=args.data_root, start_batches=state.step)
    logger = MetricLogger(out_dir)
    base_sched = trainer.cosine_schedule(stage.train.lr, stage.train)
    proj_sched = trainer.cosine_schedule(stage.train.proj_lr or stage.train.lr, stage.train)
    step_fns = {}  # one per geom presence
    max_steps = stage.train.max_steps
    print(f"training on {dev}: max_steps={max_steps} grad_accum={stage.train.grad_accum} "
          f"batch={stage.train.batch_size_per_device}", flush=True)

    stop_step = min(max_steps, args.stop_at_step) if args.stop_at_step else max_steps
    step = state.step
    loader_stall_s = 0.0
    loader_it = iter(loader)
    while True:
        t_fetch = time.time()
        batch = next(loader_it)
        loader_stall_s += time.time() - t_fetch
        if step >= stop_step:
            break
        has_geom = batch["geom_token"] is not None
        if has_geom not in step_fns:
            step_fns[has_geom] = trainer.make_train_step(stage, tx, image_token_id, has_geom=has_geom)
        gen = trainer.step_generator(stage.train.seed + 1, step, dev)
        state, metrics = step_fns[has_geom](state, to_device(batch, dev), gen)
        if step % stage.train.log_every_steps == 0:
            loss = float(metrics["loss"])
            logger.console(step, max_steps, loss, float(base_sched(step)), float(proj_sched(step)))
            logger.log(step, {"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                              "learning_rate_base": float(base_sched(step)),
                              "learning_rate_proj": float(proj_sched(step)),
                              "loader_stall_s": loader_stall_s}, max_steps=max_steps)
            loader_stall_s = 0.0
        step += 1
        if stage.train.save_every_steps and step % stage.train.save_every_steps == 0:
            ckpt.save(state, out_dir / f"step_{step}")
            print(f"checkpoint → {out_dir / f'step_{step}'}", flush=True)

    final_dir = out_dir / f"step_{step}"
    if not final_dir.exists():  # a periodic save may have landed on this step
        ckpt.save(state, final_dir)
    logger.close()
    print(f"done at step {step}; final checkpoint → {final_dir}", flush=True)


if __name__ == "__main__":
    main()
