"""Benches of the port on one CUDA card: the root ``bench.py``'s decode mode
(the JAX package's headline, the default) and its train mode.

    python -m vggt_qwen3_tpu_torch.bench [--batch 368] [--prompt 32] [--decode 128] \\
        [--quant w8|w8a8|none] [--kv int8|bf16] [--seed 0] [--device cuda] [--tiny]
    python -m vggt_qwen3_tpu_torch.bench --mode train [--cycle K] [--opt adam8bit|adamw] \\
        [--vquant w8a8|w8|none] [--textq w8|none] [--phases] [--seed 0] [--device cuda] [--tiny]

**Decode** (``--mode decode``). Qwen3-4B with seeded random bf16 weights
made on the device, quantized to W8 or W8A8 (``qwen3.quantize_params``; the
root bench's ``BENCH_QUANT``); B rows of a prompt of random ids
(``np.random.default_rng(seed).integers(1, V, (B, P))``, all valid), greedy
decode with repetition penalty 1.0 and no EOS, so ``engine.generate`` takes
its pure-greedy fast path (the fused head-argmax over the int8 embedding;
under W8 the fused W8 layer kernels, under W8A8 int8×int8 products) over an
int8 KV cache. One warm-up ``generate``, then two timed ones.

Printed: tokens/s = B·decode / the least wall time of a timed ``generate``
(host clock around a call that ends in a copy of the tokens to the host,
prefill included), the decode step time ((that time − a prefill-only
``generate``'s) / decode), peak device memory, and the card's name and
power limit (``nvidia-smi``). The last line is one JSON object of the same.
``--tiny`` swaps in the tiny preset, for a run on the CPU (``--device cpu``).

**Train** (``--mode train``; the root ``bench.py``'s ``train_mode``). The
stage-1 recipe (``configs/stage1_3d.yaml``: B 6, 8 views at 448², text 512,
LoRA r16 on qkvo, the projector and the geom head trainable) on seeded random
weights, with the frozen weights quantized as the recipe trains on one card:
the VGGT tower through ``vlm.quantize_vision(mode=--vquant)`` (default W8A8),
the Qwen3 base through ``qwen3.quantize_params(mode=--textq)`` (default W8,
the tied embedding int8 too) with the LoRA adapters re-attached after
quantizing (the QLoRA recipe). Gradients exist only for the trainable set
(projector, geom head, adapters); under W8 the backward runs through the
dequantized matmuls to the activations. One seeded batch of the recipe's
shapes (random views in [0, 1], random ids with an ``<image>`` at position
4, the first 8 labels masked, random geometry) is used throughout; the
Perceiver's dropout runs from a seeded generator.

Timed with the host clock around synchronised calls: a micro step (loss and
gradients) as the least of 3 after a warm-up; the cycle, ``--cycle k`` micro
steps (default the recipe's ``grad_accum``) each handed to the trainer's
optimizer (``train.trainer.Optimizer`` at ``grad_accum`` k: MultiSteps, the
global-norm clip and, by ``--opt``, 8-bit AdamW — the default — or AdamW, two
groups on the recipe's schedule), the update inside the timing, as the least
of 2 after a warm-up. The update residual is cycle − k·micro; the recipe step
is accum·micro + residual. Printed: those times, text tokens/s (accum·B·T a
recipe step), MFU (the root bench's FLOP count, 2·N_vis·vision tokens +
6·N_text·text tokens + 6·N_proj·B·latents, over the card's dense bf16 peak,
989 TFLOP/s on an H100), peak device memory and the card's name and power
limit; the last line is one JSON object of them. ``--phases`` also times the
vision+projector forward and the full loss forward (no gradients), the
backward being the micro step less the forward. Unlike the root bench there
is no re-run at a smaller batch on an out-of-memory error (that ladder was
for a 16 GB chip): the run fails with it. ``--tiny`` runs the mode on the
CPU (tiny presets, float32, B 2, 2 views at 56², text 64).

The other ``BENCH_MODE``s of the root bench (e2e, qa, serve, serve_sla, ring,
spec) are not ported (ROADMAP).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .config import (QWEN3_4B_INSTRUCT_2507, QWEN3_TINY, VGGT_TINY, PerceiverConfig, Qwen3Config, StageConfig,
                     load_stage_config)
from .inference.engine import GenerationConfig, generate
from .models import qwen3, vlm
from .models.common import torch_dtype
from .ops import quant
from .train import trainer

TIMED_RUNS = 2


@dataclasses.dataclass
class Setup:
    cfg: Qwen3Config
    params: dict
    embeds: torch.Tensor
    mask: torch.Tensor
    gen_cfg: GenerationConfig


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Decode-throughput and training benches of the PyTorch/CUDA port.")
    p.add_argument("--mode", choices=("decode", "train"), default="decode")
    p.add_argument("--batch", type=int, default=368)
    p.add_argument("--prompt", type=int, default=32)
    p.add_argument("--decode", type=int, default=128)
    p.add_argument("--quant", choices=("w8", "w8a8", "none"), default="w8")
    p.add_argument("--kv", choices=("int8", "bf16"), default="int8")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="the tiny preset (CPU rehearsal)")
    t = p.add_argument_group("train mode")
    t.add_argument("--cycle", type=int, default=None, help="micro steps a timed cycle (default: grad_accum)")
    t.add_argument("--opt", choices=("adam8bit", "adamw"), default="adam8bit")
    t.add_argument("--vquant", choices=("w8a8", "w8", "none"), default="w8a8", help="the frozen tower's weights")
    t.add_argument("--textq", choices=("w8", "none"), default="w8", help="the frozen Qwen3 base's weights")
    t.add_argument("--phases", action="store_true", help="also time the vision and loss forwards")
    args = p.parse_args(argv)
    if args.mode == "train" and args.tiny and args.device == "cuda":
        args.device = "cpu"  # --tiny rehearses the train mode on the CPU
    return args


def setup(args: argparse.Namespace) -> Setup:
    """Seeded random weights on the device (quantized unless ``--quant
    none``), the prompt's embeddings and mask, the generation config."""
    dev = resolve_device(args.device)
    cfg = QWEN3_TINY if args.tiny else QWEN3_4B_INSTRUCT_2507
    params = qwen3.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    if args.quant != "none":
        params = qwen3.quantize_params(params, mode=args.quant)  # frees each bf16 matrix as it goes
    ids = np.random.default_rng(args.seed).integers(1, cfg.vocab_size, (args.batch, args.prompt))
    with torch.inference_mode():
        embeds = qwen3.embed_tokens(params, torch.from_numpy(ids).to(dev))
    mask = torch.ones((args.batch, args.prompt), dtype=torch.int32, device=dev)
    gen_cfg = GenerationConfig(max_new_tokens=args.decode, eos_token_id=None, pad_token_id=0,
                               repetition_penalty=1.0, no_repeat_ngram=0,
                               kv_dtype="int8" if args.kv == "int8" else "bfloat16")
    return Setup(cfg, params, embeds, mask, gen_cfg)


def timed_generate(s: Setup, gen_cfg: Optional[GenerationConfig] = None):
    """(tokens [B, N], wall seconds) of one ``generate``; the copy of the
    tokens to the host ends it."""
    t = time.perf_counter()
    tokens, _ = generate(s.params, s.cfg, gen_cfg or s.gen_cfg, inputs_embeds=s.embeds, attention_mask=s.mask)
    return tokens, time.perf_counter() - t


def card_line() -> str:
    """``name, power.limit`` as ``nvidia-smi`` reports the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def run(args: argparse.Namespace, around_rep: Optional[Callable[[int], contextlib.AbstractContextManager]] = None,
        s: Optional[Setup] = None) -> dict:
    """Warm-up, a prefill-only ``generate``, then ``TIMED_RUNS`` timed ones,
    each inside ``around_rep(i)`` when given. Returns the metrics and the
    timed runs' tokens."""
    s = s or setup(args)
    dev = s.embeds.device
    cuda = dev.type == "cuda"
    timed_generate(s)  # warm-up: first launches load the kernels
    _, prefill_s = timed_generate(s, dataclasses.replace(s.gen_cfg, max_new_tokens=0))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    walls, tokens = [], []
    for i in range(TIMED_RUNS):
        with (around_rep(i) if around_rep else contextlib.nullcontext()):
            tok, secs = timed_generate(s)
        walls.append(secs)
        tokens.append(tok)
    wall = min(walls)
    return dict(
        model="qwen3-tiny" if args.tiny else "qwen3-4b", batch=args.batch, prompt=args.prompt,
        decode=args.decode, quant=args.quant, kv=args.kv, device=str(dev),
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        card=card_line() if cuda else None,
        tok_s=args.batch * args.decode / wall, walls_s=walls, prefill_s=prefill_s,
        step_ms=(wall - prefill_s) / max(args.decode, 1) * 1e3,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
        tokens=tokens,
    )


# ---------------------------------------------------------------------------
# train mode
# ---------------------------------------------------------------------------

RECIPE = Path(__file__).resolve().parents[1] / "configs" / "stage1_3d.yaml"
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak of an H100 SXM
MICRO_REPS, CYCLE_REPS = 3, 2


@dataclasses.dataclass
class TrainSetup:
    stage: StageConfig
    params: dict  # the whole tree; the trainable leaves are the tensors of ``trainable``
    trainable: Dict[str, torch.Tensor]  # name → leaf: projector, geom head, LoRA adapters
    batch: dict
    tx: trainer.Optimizer
    opt_state: dict
    img_id: int
    B: int
    V: int
    S: int
    T: int
    accum: int
    k: int
    seed: int


def train_stage(args: argparse.Namespace) -> StageConfig:
    """The recipe (``RECIPE``; with ``--tiny`` the tiny presets, float32, a
    tiny Perceiver and 16 vision tokens, as the root bench's tiny mode)."""
    stage = load_stage_config(RECIPE, text_config=QWEN3_TINY if args.tiny else None,
                              vision_config=VGGT_TINY if args.tiny else None)
    if args.tiny:
        stage = dataclasses.replace(stage, model=dataclasses.replace(
            stage.model, num_vis_tokens=16, dtype="float32",
            projector=PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128)))
    return stage


def train_batch(stage: StageConfig, B: int, V: int, S: int, T: int, img_id: int, seed: int, dev) -> dict:
    """The root bench's seeded batch: views uniform in [0, 1], ids uniform in
    [1, vocab) with ``<image>`` at position 4, the first 8 labels masked,
    normal geometry."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0, 1, (B, V, 3, S, S))).to(dev, torch_dtype(stage.model.dtype))
    ids = rng.integers(1, stage.model.text.vocab_size, (B, T))
    ids[:, 4] = img_id
    labels = np.where(np.arange(T)[None] < 8, -100, ids)
    geom = {k: torch.from_numpy(rng.normal(size=(B, V, n))).to(dev, torch.float32)
            for k, n in (("R", 9), ("t", 3), ("K", 9), ("depth_hist", 16))}
    return dict(pixel_values=images, input_ids=torch.from_numpy(ids).to(dev),
                attention_mask=torch.ones((B, T), dtype=torch.int32, device=dev),
                labels=torch.from_numpy(labels).to(dev), geom_token=geom)


def quantize_frozen(params: dict, vquant: str, textq: str) -> dict:
    """The recipe's frozen weights quantized: the tower (``quantize_vision``)
    and the Qwen3 base with its embedding (``quantize_params``), the LoRA
    adapters re-attached after quantizing."""
    if vquant != "none":
        params = vlm.quantize_vision(params, mode=vquant)
    if textq != "none":
        lora = params["text"]["layers"].get("lora")
        params["text"] = qwen3.quantize_params(params["text"], mode=textq)
        if lora is not None:
            params["text"]["layers"]["lora"] = lora
    return params


def train_setup(args: argparse.Namespace, stage: Optional[StageConfig] = None,
                params: Optional[dict] = None) -> TrainSetup:
    """Seeded random weights on the device (LoRA added, the frozen weights
    quantized; or ``params``, such a tree already made), the trainable split,
    the optimizer over it and the batch."""
    dev = resolve_device(args.device)
    stage = stage or train_stage(args)
    B = 2 if args.tiny else stage.train.batch_size_per_device
    V = 2 if args.tiny else stage.data.num_views
    S = VGGT_TINY.img_size if args.tiny else stage.data.image_size
    T = 64 if args.tiny else stage.data.max_length
    accum = stage.train.grad_accum
    k = max(1, min(args.cycle or accum, accum))
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = vlm.init_params(gen, stage.model)
        if stage.lora.enable:
            params["text"] = qwen3.add_lora(params["text"], stage.model.text, stage.lora, gen)
        params = quantize_frozen(params, args.vquant, args.textq)
    labels = trainer.param_group_labels(params, True, lora=stage.lora.enable)
    trainable = {n: t for n, t in trainer.named_leaves(params) if labels[n] != "frozen"}
    cfg = dataclasses.replace(stage.train, optimizer="adamw8bit" if args.opt == "adam8bit" else "adamw", grad_accum=k)
    tx = trainer.Optimizer(cfg, labels, freeze_text_layers=stage.freeze_text_layers,
                           num_text_layers=stage.model.text.num_layers)
    img_id = stage.model.text.vocab_size - 1
    return TrainSetup(stage=stage, params=params, trainable=trainable,
                      batch=train_batch(stage, B, V, S, T, img_id, args.seed, dev), tx=tx, opt_state=tx.init(params),
                      img_id=img_id, B=B, V=V, S=S, T=T, accum=accum, k=k, seed=args.seed)


def train_micro(s: TrainSetup, step: int = 0):
    """One micro step: (loss, gradients of the trainable leaves by name).
    Only the trainable leaves require gradients."""
    gen = torch.Generator(device=s.batch["input_ids"].device).manual_seed(s.seed * 1000 + step)
    leaves = list(s.trainable.values())
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = vlm.train_forward(s.params, s.stage.model, images=s.batch["pixel_values"],
                                 geom_token=s.batch["geom_token"], input_ids=s.batch["input_ids"],
                                 attention_mask=s.batch["attention_mask"], labels=s.batch["labels"],
                                 image_token_id=s.img_id, generator=gen)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), dict(zip(s.trainable, grads))


def train_cycle(s: TrainSetup, step: int = 0) -> torch.Tensor:
    """``k`` micro steps handed to the optimizer; the last one's update runs.
    Returns the mean loss."""
    total = 0.0
    for i in range(s.k):
        loss, grads = train_micro(s, step + i)
        emitted = s.tx.update(grads, s.opt_state, s.params)
        del grads
        total = total + loss
    if not emitted:
        raise AssertionError(f"a cycle of {s.k} micro steps at grad_accum {s.k} applied no update")
    return total / s.k


def _timed(fn, dev) -> Tuple[float, object]:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t, out


def param_count(tree: dict) -> int:
    """Elements of a tree's weights, quantized ones counted by their int8
    matrix (no scales or markers), LoRA adapters left out."""
    n = 0
    for name, t in trainer.named_leaves(tree):
        keys = name.split("/")
        if "lora" in keys or keys[-1] in ("scale", quant.A8_MARKER, "gscale"):
            continue
        n += t.numel()
    return n


def train_flops(s: TrainSetup) -> float:
    """The root bench's count for one micro step: the frozen tower's forward,
    the text model's forward and activation backward, the projector's
    forward and backward."""
    m = s.stage.model
    vis_tokens = s.B * s.V * (1 + m.vision.num_register_tokens + (s.S // m.vision.patch_size) ** 2)
    return (2 * param_count(s.params["vision"]) * vis_tokens + 6 * param_count(s.params["text"]) * s.B * s.T
            + 6 * param_count(s.params["projector"]) * s.B * m.projector.num_latents)


def train_phases(s: TrainSetup) -> dict:
    """Least of 3 (after a warm-up) of the vision+projector forward and of the
    full loss forward, without gradients."""
    m, b = s.stage.model, s.batch
    dev = b["input_ids"].device

    def vision():
        return vlm.encode_images(s.params, m, b["pixel_values"]).sum()

    def loss():
        return vlm.train_forward(s.params, m, images=b["pixel_values"], geom_token=b["geom_token"],
                                 input_ids=b["input_ids"], attention_mask=b["attention_mask"], labels=b["labels"],
                                 image_token_id=s.img_id)

    out = {}
    with torch.no_grad():
        for name, fn in (("vision_s", vision), ("loss_forward_s", loss)):
            fn()
            out[name] = min(_timed(fn, dev)[0] for _ in range(MICRO_REPS))
    return out


def train_measure(s: TrainSetup, phases: bool = False) -> dict:
    """The train mode's timings and metrics (module note)."""
    dev = s.batch["input_ids"].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    warm_s, (loss0, grads) = _timed(lambda: train_micro(s, 0), dev)
    del grads
    micro_walls, losses = [], [float(loss0)]
    for i in range(MICRO_REPS):
        secs, (loss, grads) = _timed(lambda: train_micro(s, 1 + i), dev)
        del grads
        micro_walls.append(secs)
        losses.append(float(loss))
    cycle_walls = []
    for i in range(1 + CYCLE_REPS):  # a warm-up cycle (the optimizer state's first touch), then the timed ones
        secs, loss = _timed(lambda: train_cycle(s, 100 * (i + 1)), dev)
        losses.append(float(loss))
        if i:
            cycle_walls.append(secs)
    micro_s, cycle_s = min(micro_walls), min(cycle_walls)
    residual = cycle_s - s.k * micro_s
    step_s = s.accum * micro_s + max(residual, 0.0)
    flops = train_flops(s)
    res = dict(
        mode="train", model="tiny" if s.stage.model.text.hidden_size < 1024 else "qwen3-4b+vggt-1b+perceiver_small",
        batch=s.B, views=s.V, image=s.S, text=s.T, accum=s.accum, cycle=s.k,
        opt="adam8bit" if s.tx.cfg.optimizer == "adamw8bit" else "adamw",
        device=str(dev), kind=torch.cuda.get_device_name(dev) if cuda else "cpu", card=card_line() if cuda else None,
        warmup_s=warm_s, micro_s=micro_s, micro_walls_s=micro_walls, cycle_s=cycle_s, cycle_walls_s=cycle_walls,
        update_residual_s=residual, step_s=step_s, tok_s=s.accum * s.B * s.T / step_s,
        flops_micro=flops, mfu=flops / micro_s / H100_BF16_FLOPS if cuda else None,
        mfu_peak="H100 dense bf16 989 TFLOP/s" if cuda else None,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
        losses=losses, trainable_params=sum(t.numel() for t in s.trainable.values()),
    )
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train bench: a loss is not finite: {losses}")
    if phases:
        ph = train_phases(s)
        res.update(ph, backward_s=micro_s - ph["loss_forward_s"], text_forward_s=ph["loss_forward_s"] - ph["vision_s"])
    return res


def train_main(args: argparse.Namespace) -> dict:
    s = train_setup(args)
    res = train_measure(s, phases=args.phases)
    print(f"bench train: {res['model']} B={s.B} views={s.V} {s.S}px text={s.T}, {res['trainable_params'] / 1e9:.3f} B "
          f"trainable, vision {args.vquant}, frozen text {args.textq}, {res['opt']}; on {res['kind']} ({res['card']})",
          flush=True)
    mfu = "not measured (CPU)" if res["mfu"] is None else f"{100 * res['mfu']:.2f}% of the {res['mfu_peak']}"
    print(f"micro step {res['micro_s']:.4f} s (walls {', '.join(f'{w:.4f}' for w in res['micro_walls_s'])}); cycle of "
          f"{s.k} micro + update {res['cycle_s']:.4f} s → update residual {res['update_residual_s']:.4f} s; "
          f"recipe step (accum {s.accum}) {res['step_s']:.3f} s; {res['tok_s']:.1f} text tokens/s; MFU {mfu}; "
          f"peak memory {res['peak_gib']} GiB", flush=True)
    if args.phases:
        print(f"phases: vision+projector forward {res['vision_s']:.4f} s, text+splice+loss forward "
              f"{res['text_forward_s']:.4f} s, backward {res['backward_s']:.4f} s", flush=True)
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mode == "train":
        return train_main(args)
    res = run(args)
    print(f"bench: {res['model']} B={args.batch} prompt={args.prompt} decode={args.decode} "
          f"quant={args.quant} kv={args.kv} on {res['kind']} ({res['card']})", flush=True)
    print(f"{res['tok_s']:.1f} tok/s (walls {', '.join(f'{w:.3f}' for w in res['walls_s'])} s), "
          f"prefill {res['prefill_s'] * 1e3:.1f} ms, decode step {res['step_ms']:.2f} ms, "
          f"peak memory {res['peak_gib']} GiB", flush=True)
    print(json.dumps({k: v for k, v in res.items() if k != "tokens"}), flush=True)
    return res


if __name__ == "__main__":
    main()
