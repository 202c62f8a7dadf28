"""The root ``bench.py``'s modes on the port, on one CUDA card: decode (the
JAX package's headline, the default), train, e2e, qa, spec, serve,
serve_sla and ring.

    python -m vggt_qwen3_tpu_torch.bench [--batch 368] [--prompt 32] [--decode 128] \\
        [--quant w8|w8a8|w4|none] [--kv int8|bf16] [--seed 0] [--device cuda] [--tiny]
    python -m vggt_qwen3_tpu_torch.bench --mode train [--cycle K] [--opt adam8bit|adamw] \\
        [--vquant w8a8|w8|none] [--textq w8|none] [--phases] [--seed 0] [--device cuda] [--tiny]
    python -m vggt_qwen3_tpu_torch.bench --mode e2e|qa|spec|serve|serve_sla|ring [mode flags] \\
        [--quant ...] [--seed 0] [--device cuda] [--tiny]

Every mode builds seeded random weights on the device (throughput does not
depend on their values; the root bench's iota/sin ``_cheap_params`` are not
ported) and prints the card's name and power limit (``nvidia-smi``); the
last line printed is one JSON object holding the root bench's metric name
and value (no ``vs_baseline``: that was a ratio to a TPU target). Each of the
six modes below is a function of ``args`` and of what it can take from its
caller: a prepared weight tree (``params=``, the text quantized as
``--quant`` asks; all but ring) and a count of timed repetitions (``reps=``;
e2e, qa, spec and ring), which replace its own (``chip_smoke.py`` shares one
tree among them and cuts the repetitions); every timing follows a warm-up
call, and the CLI keeps the root bench's counts. Queries run eagerly
(``batching.spliced_prompt``, then the engine), where the root jits each
into one program; there is no CUDA graph.

``--tiny`` swaps in the tiny presets in every mode; the device stays
``--device``'s (cuda by default) but in train mode, which ``--tiny`` moves
to the CPU. In the six modes below the tiny presets run in float32 with
dense text weights (as the root bench's tiny modes: ``--quant`` other than
none is refused there) and, but in qa, the model-dtype cache:
``--tiny --device cpu`` rehearses them on the CPU. Without a card each mode
raises unless asked for the CPU.

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

**e2e** (root ``e2e_mode``): one 448² view → VGGT-1B → the Perceiver (128
tokens) → splice into 30 ids (``<image>`` at 10) → prefill → 32 greedy
tokens, penalty 1.1, W8 text by ``--quant``: the whole query (least of 5),
TTFT (one new token, least of 5), the decode tail a token, and the
early-exit curve (budgets 2–32 through ``generate_early_exit(budget=k)``,
least of 4, with its steps). Metric ``e2e_single_view_query_ms``.

**qa** (root ``qa_mode``): ``--qa_batch`` (32) such queries at once with an
int8 KV cache, the tower by ``--vquant`` (default none here); least of 3.
Metric ``qa_samples_per_sec_chip``.

**spec** (root ``spec_mode``): ``generate`` against ``generate_speculative``
(``--spec_k`` 6, ngram 3) at ``--spec_batch`` 1 for ``--spec_decode`` 64
tokens over a 12-token FSM cycle written into the prompt's tail, constrained
and free (least of 4 each, with the verify iterations); with ``--spec_e2e``
(default) the action query (448² view → VGGT → splice → 96 constrained
tokens), plain against speculative. KV by ``--kv``. Metric
``spec_decode_json_speedup``.

**serve** (root ``serve_mode``): the slot engine on the text-only model (W8,
int8 KV, decode chunk 4): ``--serve_reqs`` 64 requests of prompt 32, budgets
cycled over [8, 32], on ``--slots`` 16, after a closed warm-up pass of
4·slots requests; ``--serve_struct`` (the 8-token FSM cycle), ``--serve_spec``
(speculative chunks), ``--spec_guard 0`` (guard gain 0). Requests/s, served
tokens/s, chunks, mid-decode admissions, admit dispatches, admission wait,
KV occupancy, verify blocks. Metric ``served_requests_per_sec``.

**serve_sla** (root ``serve_sla_mode``): the same engine with
``track_metrics``; two closed passes (the second gives the capacity), then
Poisson arrivals (``default_rng(7)``) at ``--sla_loads`` 0.5,1.0,1.5 × the
capacity, ``--sla_reqs`` 96 each, served from the engine's own thread:
TTFT, admission wait and inter-token latency at p50/p99. Metric
``serve_sla_p99_ttft_ms`` (at 1.0×).

**ring** (root ``ring_mode``): the 32-view VGGT global-attention shape
``[1, 32·1029, 16, 64]`` bf16 (``--ring_views``): the direct flash forward
(least of 3), the two-chunk logsumexp merge and ``ring_attention_sharded``
over a one-rank group (NCCL on the card, gloo on the CPU; an in-process
store, no address), each held to the direct output within 0.05 × its scale,
or the run exits non-zero. Ring attention over several ranks is checked on
the CPU only (``tests/test_torch_ring_attention.py``: gloo ranks in
processes of their own). Metric ``ring_32view_flash_ms``.
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
from .config import (QWEN3_4B_INSTRUCT_2507, QWEN3_TINY, VGGT_1B, VGGT_TINY, DataConfig, PerceiverConfig, Qwen3Config,
                     StageConfig, TrainConfig, VLMConfig, load_stage_config)
from .inference import batching
from .inference import slots as slots_mod
from .inference.engine import GenerationConfig, generate, generate_early_exit
from .inference.speculative import generate_speculative
from .models import qwen3, vlm
from .models.common import torch_dtype
from .ops import quant, ring_attention
from .ops.flash_attention import flash_attention, flash_attention_with_lse
from .train import trainer

TIMED_RUNS = 2


@dataclasses.dataclass
class Setup:
    cfg: Qwen3Config
    params: dict
    embeds: torch.Tensor
    mask: torch.Tensor
    gen_cfg: GenerationConfig


QUERY_MODES = ("e2e", "qa", "spec", "serve", "serve_sla", "ring")  # the root bench's other modes
MODES = ("decode", "train", *QUERY_MODES)
DENSE = "none"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="The root bench's modes on the PyTorch/CUDA port.")
    p.add_argument("--mode", choices=MODES, default="decode")
    p.add_argument("--batch", type=int, default=368)
    p.add_argument("--prompt", type=int, default=32)
    p.add_argument("--decode", type=int, default=128)
    p.add_argument("--quant", choices=("w8", "w8a8", "w4", "none"), default=None,
                   help="the text weights in every mode but train (default w8; with --tiny, none in the "
                        "e2e/qa/spec/serve/serve_sla/ring modes, which take no other)")
    p.add_argument("--kv", choices=("int8", "bf16"), default="int8", help="the KV cache of decode and spec")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="the tiny preset (CPU rehearsal)")
    t = p.add_argument_group("train mode")
    t.add_argument("--cycle", type=int, default=None, help="micro steps a timed cycle (default: grad_accum)")
    t.add_argument("--opt", choices=("adam8bit", "adamw"), default="adam8bit")
    t.add_argument("--vquant", choices=("w8a8", "w8", "none"), default=None,
                   help="the frozen tower's weights (default: w8a8 in train mode, none in qa mode)")
    t.add_argument("--textq", choices=("w8", "none"), default="w8", help="the frozen Qwen3 base's weights")
    t.add_argument("--phases", action="store_true", help="also time the vision and loss forwards")
    m = p.add_argument_group("e2e, qa, spec, serve, serve_sla and ring modes (defaults: the root bench's)")
    m.add_argument("--qa_batch", type=int, default=None, help="qa: samples a batch (32; tiny 2)")
    m.add_argument("--spec_batch", type=int, default=1)
    m.add_argument("--spec_k", type=int, default=None, help="spec: drafts a verify block (6; tiny 4)")
    m.add_argument("--spec_decode", type=int, default=None, help="spec: new tokens (64; tiny 16)")
    m.add_argument("--spec_e2e", action=argparse.BooleanOptionalAction, default=True,
                   help="spec: also the vision action query, plain against speculative")
    m.add_argument("--spec_action_tokens", type=int, default=None, help="spec: the action query's tokens (96; tiny 16)")
    m.add_argument("--serve_reqs", type=int, default=None, help="serve: requests (64; tiny 8)")
    m.add_argument("--slots", type=int, default=None, help="serve, serve_sla: KV slots (16; tiny 4)")
    m.add_argument("--serve_prompt", type=int, default=32, help="serve, serve_sla: prompt length (tiny 8)")
    m.add_argument("--serve_new", type=int, default=32, help="serve, serve_sla: new tokens (tiny 8)")
    m.add_argument("--serve_struct", action="store_true", help="serve, serve_sla: FSM-constrained output")
    m.add_argument("--serve_spec", action="store_true", help="serve, serve_sla: speculative chunks (implies struct)")
    m.add_argument("--spec_guard", type=int, choices=(0, 1), default=1,
                   help="serve: 0 turns the speculative guard off (gain 0)")
    m.add_argument("--sla_reqs", type=int, default=None, help="serve_sla: requests a load (96; tiny 8)")
    m.add_argument("--sla_loads", default="0.5,1.0,1.5", help="serve_sla: loads as multiples of the capacity")
    m.add_argument("--ring_views", type=int, default=None, help="ring: views (32; tiny 2)")
    args = p.parse_args(argv)
    dense_tiny = args.tiny and args.mode in QUERY_MODES  # the root bench's tiny modes keep their text dense
    if dense_tiny and args.quant not in (None, DENSE):
        p.error(f"--mode {args.mode} --tiny runs dense text weights: --quant {args.quant} is not taken")
    if args.quant is None:
        args.quant = DENSE if dense_tiny else "w8"
    if args.mode == "train" and args.tiny and args.device == "cuda":
        args.device = "cpu"  # --tiny rehearses the train mode on the CPU
    if args.vquant is None:
        args.vquant = "w8a8" if args.mode == "train" else "none"
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
TINY_PERCEIVER = PerceiverConfig(latent_dim=64, num_latents=16, num_heads=4, num_layers=2, ffn_dim=128)
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
            stage.model, num_vis_tokens=16, dtype="float32", projector=TINY_PERCEIVER))
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


def train_measure(s: TrainSetup, phases: bool = False, micro_reps: int = MICRO_REPS,
                  cycle_reps: int = CYCLE_REPS) -> dict:
    """The train mode's timings and metrics (module note): the least of
    ``micro_reps`` timed micro steps and of ``cycle_reps`` timed cycles."""
    dev = s.batch["input_ids"].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    warm_s, (loss0, grads) = _timed(lambda: train_micro(s, 0), dev)
    del grads
    micro_walls, losses = [], [float(loss0)]
    for i in range(micro_reps):
        secs, (loss, grads) = _timed(lambda: train_micro(s, 1 + i), dev)
        del grads
        micro_walls.append(secs)
        losses.append(float(loss))
    cycle_walls = []
    for i in range(1 + cycle_reps):  # a warm-up cycle (the optimizer state's first touch), then the timed ones
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


# ---------------------------------------------------------------------------
# the root bench's other modes: e2e, qa, spec, serve, serve_sla, ring
# ---------------------------------------------------------------------------

QUERY_LEN, IMAGE_AT, RAND_ID_HIGH = 30, 10, 150_000  # the e2e and qa queries: 30 ids, <image> at 10
SPEC_CYCLE = (101, 5, 72, 880, 14, 3301, 9, 42, 7, 615, 23, 11)  # spec: a 12-state JSON-like skeleton
SERVE_CYCLE = (7, 23, 5, 41, 9, 42, 11, 3301)  # serve --serve_struct: an 8-state skeleton
SPEC_PROMPT = 32
EARLY_EXIT_BUDGETS = (2, 4, 8, 16, 32)


def _reps(default: int, reps: Optional[int]) -> int:
    """Timed repetitions: ``reps``, else the root bench's count."""
    return default if reps is None else max(1, reps)


def text_config(args) -> Qwen3Config:
    """Qwen3-4B, or with ``--tiny`` the tiny preset in float32."""
    return dataclasses.replace(QWEN3_TINY, dtype="float32") if args.tiny else QWEN3_4B_INSTRUCT_2507


def vlm_config(args) -> VLMConfig:
    """The root bench's query model: VGGT-1B, the Perceiver to 128 tokens, no
    geometry tokens, bf16; with ``--tiny`` the tiny presets, a 2-layer
    Perceiver to 16 tokens, float32."""
    if args.tiny:
        return VLMConfig(text=text_config(args), vision=dataclasses.replace(VGGT_TINY, dtype="float32"),
                         projector=TINY_PERCEIVER, num_vis_tokens=16, geom_tokens=0, dtype="float32")
    return VLMConfig(text=QWEN3_4B_INSTRUCT_2507, vision=VGGT_1B, projector=PerceiverConfig(), num_vis_tokens=128,
                     geom_tokens=0, dtype="bfloat16")


def vlm_params(args, cfg: Optional[VLMConfig] = None) -> dict:
    """Seeded random VLM weights on the device, the text quantized by
    ``--quant`` (``qwen3.quantize_params`` frees each dense matrix as it
    goes); the tower stays dense (qa's ``--vquant`` applies on top)."""
    dev = resolve_device(args.device)
    params = vlm.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg or vlm_config(args))
    if args.quant != DENSE:
        params["text"] = qwen3.quantize_params(params["text"], mode=args.quant)
    return params


def text_params(args) -> dict:
    """Seeded random Qwen3 weights on the device, quantized as
    :func:`vlm_params` quantizes the text."""
    dev = resolve_device(args.device)
    params = qwen3.init_params(torch.Generator(device=dev).manual_seed(args.seed), text_config(args))
    if args.quant != DENSE:
        params = qwen3.quantize_params(params, mode=args.quant)
    return params


def _text_of(params: dict) -> dict:
    return params["text"] if "text" in params else params


def _device_of(params: dict) -> torch.device:
    return _text_of(params)["final_norm"].device


def _query_stage(cfg: VLMConfig, image_size: int) -> StageConfig:
    """A stage holding the query model, for ``batching.spliced_prompt``."""
    return StageConfig(model=cfg, data=DataConfig(num_views=1, image_size=image_size), train=TrainConfig())


def _image_size(args, cfg: VLMConfig) -> int:
    return cfg.vision.img_size if args.tiny else 448


def query_inputs(cfg: VLMConfig, B: int, image_size: int, dev):
    """The root e2e/qa draws: B views uniform in [0, 1] (``default_rng(0)``),
    B × 30 ids in [1, 150000) (``default_rng(1)``; below the vocabulary with
    ``--tiny``) with ``<image>`` (the last id) at position 10, all valid.
    → (images, ids, mask, image token id)."""
    img_id = cfg.text.vocab_size - 1
    images = np.random.default_rng(0).uniform(0, 1, (B, 1, 3, image_size, image_size))
    ids = np.random.default_rng(1).integers(1, min(RAND_ID_HIGH, cfg.text.vocab_size - 1), (B, QUERY_LEN))
    ids[:, IMAGE_AT] = img_id
    return (torch.from_numpy(images).to(dev, torch_dtype(cfg.dtype)), torch.from_numpy(ids).to(dev),
            torch.ones((B, QUERY_LEN), dtype=torch.int32, device=dev), img_id)


def fsm_cycle(tokens, V: int) -> list:
    """The root bench's skeleton fitted to a vocabulary: t % (V − 2) + 1."""
    return [t % (V - 2) + 1 for t in tokens]


def cycle_table(cycle, V: int, dev) -> torch.Tensor:
    """FSM table [len(cycle), V]: state s allows only cycle[s], then s + 1."""
    table = np.full((len(cycle), V), -1, np.int32)
    for st, t in enumerate(cycle):
        table[st, t] = (st + 1) % len(cycle)
    return torch.from_numpy(table).to(dev)


def _least(fn, dev, reps: int):
    """(least wall seconds of ``reps`` calls after a warm-up call, the last
    call's output)."""
    fn()
    walls, out = [], None
    for _ in range(reps):
        secs, out = _timed(fn, dev)
        walls.append(secs)
    return min(walls), out


def _card(dev) -> dict:
    cuda = dev.type == "cuda"
    return dict(device=str(dev), kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                card=card_line() if cuda else None)


def e2e_mode(args, params: Optional[dict] = None, reps: Optional[int] = None) -> dict:
    """The root ``e2e_mode``: one single-view query — 448² view → VGGT-1B →
    Perceiver (128) → splice → prefill → 32 greedy tokens, penalty 1.1 —
    timed whole (least of 5 after a warm-up), its TTFT (the same query with
    one new token, least of 5), the decode tail a token, and the early-exit
    curve: answer budgets 2–32 through ``generate_early_exit(budget=k)``
    (least of 4 each, and the steps it ran). Each query runs eagerly:
    ``batching.spliced_prompt`` then the engine."""
    cfg = vlm_config(args)
    params = params if params is not None else vlm_params(args, cfg)
    dev = _device_of(params)
    images, ids, mask, img_id = query_inputs(cfg, 1, _image_size(args, cfg), dev)
    stage = _query_stage(cfg, _image_size(args, cfg))
    gen_cfg = GenerationConfig(max_new_tokens=32, pad_token_id=0, repetition_penalty=1.1)
    ttft_cfg = dataclasses.replace(gen_cfg, max_new_tokens=1)

    def query(g):
        embeds, mask2 = batching.spliced_prompt(params, stage, img_id, images, ids, mask)
        return generate(params["text"], cfg.text, g, inputs_embeds=embeds, attention_mask=mask2)

    def early_exit(k):
        embeds, mask2 = batching.spliced_prompt(params, stage, img_id, images, ids, mask)
        return generate_early_exit(params["text"], cfg.text, gen_cfg, inputs_embeds=embeds, attention_mask=mask2,
                                   budget=torch.full((1,), k, dtype=torch.int32, device=dev))

    whole_s, (tokens, _) = _least(lambda: query(gen_cfg), dev, _reps(5, reps))
    ttft_s, (first, _) = _least(lambda: query(ttft_cfg), dev, _reps(5, reps))
    n_dec = gen_cfg.max_new_tokens - 1
    curve = {}
    early_exit(EARLY_EXIT_BUDGETS[-1])  # the root's one warm-up of the one-program query
    for k in EARLY_EXIT_BUDGETS:
        walls = []
        for _ in range(_reps(4, reps)):
            secs, (ee_tokens, _, steps) = _timed(lambda: early_exit(k), dev)
            walls.append(secs)
        curve[k] = dict(ms=min(walls) * 1e3, steps=steps, tokens=ee_tokens[0].tolist())
    ms, ttft_ms = whole_s * 1e3, ttft_s * 1e3
    return dict(mode="e2e", metric="e2e_single_view_query_ms", value=ms, unit="ms", quant=args.quant,
                ttft_ms=ttft_ms, decode_ms_per_token=(ms - ttft_ms) / n_dec, decode_tokens=n_dec,
                early_exit={k: {n: v for n, v in c.items() if n != "tokens"} for k, c in curve.items()},
                tokens=tokens[0].tolist(), first_token=int(first[0, 0]),
                early_exit_tokens={k: c["tokens"] for k, c in curve.items()}, **_card(dev))


def qa_mode(args, params: Optional[dict] = None, reps: Optional[int] = None) -> dict:
    """The root ``qa_mode``: a batch of ``--qa_batch`` single-view queries
    (448², VGGT-1B, Perceiver, splice, prefill, 32 greedy tokens with penalty
    1.1 over an int8 KV cache), the tower quantized by ``--vquant``; samples/s
    = B / the least wall of 3 after a warm-up."""
    cfg = vlm_config(args)
    params = params if params is not None else vlm_params(args, cfg)
    if args.vquant != DENSE:
        params = vlm.quantize_vision(params, mode=args.vquant, donate=False)
    dev = _device_of(params)
    B = args.qa_batch or (2 if args.tiny else 32)
    images, ids, mask, img_id = query_inputs(cfg, B, _image_size(args, cfg), dev)
    stage = _query_stage(cfg, _image_size(args, cfg))
    gen_cfg = GenerationConfig(max_new_tokens=32, pad_token_id=0, repetition_penalty=1.1, kv_dtype="int8")

    def batch_qa():
        embeds, mask2 = batching.spliced_prompt(params, stage, img_id, images, ids, mask)
        return generate(params["text"], cfg.text, gen_cfg, inputs_embeds=embeds, attention_mask=mask2)

    wall, (tokens, _) = _least(batch_qa, dev, _reps(3, reps))
    return dict(mode="qa", metric="qa_samples_per_sec_chip", value=B / wall, unit="samples/s", batch=B,
                quant=args.quant, vquant=args.vquant, wall_s=wall, tokens=tokens.tolist(), **_card(dev))


def _spec_kv(args) -> Optional[str]:
    """The root ``_kv_dtype``: the model's dtype with ``--tiny``, else ``--kv``."""
    return None if args.tiny else ("int8" if args.kv == "int8" else "bfloat16")


def spec_prompt(V: int, B: int, seed: int = 0) -> np.ndarray:
    """The spec mode's prompt ids: B × 32 draws in [1, V) from
    ``default_rng(seed)``, the 12-token skeleton at the tail."""
    ids = np.random.default_rng(seed).integers(1, V, (B, SPEC_PROMPT))
    ids[:, -len(SPEC_CYCLE):] = fsm_cycle(SPEC_CYCLE, V)
    return ids


def spec_mode(args, params: Optional[dict] = None, reps: Optional[int] = None) -> dict:
    """The root ``spec_mode``: prompt-lookup speculative decoding (ngram 3,
    ``--spec_k`` drafts) against ``generate`` at B ``--spec_batch``, over the
    12-token FSM cycle written into the prompt's tail (constrained: the
    high-acceptance bracket) and free (the worst case), each the least of 4
    after a warm-up; the speculative runs' verify iterations. With
    ``--spec_e2e`` also the action query: a 448² view → VGGT → splice →
    constrained decode of 96 tokens, plain against speculative."""
    cfg = text_config(args)
    if params is None:
        params = vlm_params(args) if args.spec_e2e else text_params(args)
    text = _text_of(params)
    dev = _device_of(params)
    V, B = cfg.vocab_size, args.spec_batch
    N = args.spec_decode or (16 if args.tiny else 64)
    k = args.spec_k or (4 if args.tiny else 6)
    r = _reps(4, reps)
    constraint = cycle_table(fsm_cycle(SPEC_CYCLE, V), V, dev)
    ids = torch.from_numpy(spec_prompt(V, B)).to(dev)
    with torch.inference_mode():
        embeds = qwen3.embed_tokens(text, ids)
    mask = torch.ones((B, SPEC_PROMPT), dtype=torch.int32, device=dev)
    gen_cfg = GenerationConfig(max_new_tokens=N, pad_token_id=0, kv_dtype=_spec_kv(args))
    kw = dict(inputs_embeds=embeds, attention_mask=mask)
    runs = {}
    for label, fn in (
            ("generate_constrained", lambda: generate(text, cfg, gen_cfg, constraint=constraint, **kw)),
            ("speculative_constrained", lambda: generate_speculative(text, cfg, gen_cfg, prompt_ids=ids,
                                                                     constraint=constraint, draft_k=k, ngram=3, **kw)),
            ("generate_free", lambda: generate(text, cfg, gen_cfg, **kw)),
            ("speculative_free", lambda: generate_speculative(text, cfg, gen_cfg, prompt_ids=ids, draft_k=k, ngram=3,
                                                              **kw))):
        wall, out = _least(fn, dev, r)
        runs[label] = dict(ms=wall * 1e3, iterations=out[2] if len(out) > 2 else N, tokens=out[0].tolist())
    speedup = runs["generate_constrained"]["ms"] / runs["speculative_constrained"]["ms"]
    res = dict(mode="spec", metric="spec_decode_json_speedup", value=speedup, unit="x", batch=B, draft_k=k,
               new_tokens=N, quant=args.quant, kv=gen_cfg.kv_dtype or cfg.dtype,
               worst_case_overhead=runs["speculative_free"]["ms"] / runs["generate_free"]["ms"], runs=runs)
    if args.spec_e2e:
        vcfg = dataclasses.replace(vlm_config(args), text=cfg)
        px = _image_size(args, vcfg)
        img_id = V - 1
        images = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 1, 3, px, px))).to(
            dev, torch_dtype(vcfg.dtype))
        aids_np = spec_prompt(V, 1, seed=2)
        aids_np[:, 4] = img_id
        aids = torch.from_numpy(aids_np).to(dev)
        amask = torch.ones((1, SPEC_PROMPT), dtype=torch.int32, device=dev)
        NA = args.spec_action_tokens or (16 if args.tiny else 96)
        agen = GenerationConfig(max_new_tokens=NA, pad_token_id=0, kv_dtype=_spec_kv(args))
        stage = _query_stage(vcfg, px)

        def action(speculative: bool):
            embeds2, mask2 = batching.spliced_prompt(params, stage, img_id, images, aids, amask)
            akw = dict(inputs_embeds=embeds2, attention_mask=mask2, constraint=constraint)
            if speculative:
                return generate_speculative(text, cfg, agen, lookup_ids=aids, lookup_mask=amask, draft_k=k, ngram=3,
                                            **akw)
            return generate(text, cfg, agen, **akw)

        for label, spec in (("action_plain", False), ("action_speculative", True)):
            wall, out = _least(lambda: action(spec), dev, r)
            runs[label] = dict(ms=wall * 1e3, iterations=out[2] if spec else NA, tokens=out[0].tolist())
        res.update(action_tokens=NA, action_speedup=runs["action_plain"]["ms"] / runs["action_speculative"]["ms"])
    res.update(_card(dev))
    return res


def serve_workload(V: int, n_req: int, prompt_len: int, new_tokens: int, struct: bool):
    """The root serve/serve_sla draws: request i's ids are ``[1, P]`` from
    ``default_rng(0)`` in order (the 8-token skeleton at the tail when
    structured), its budget ``lo + i % (N − lo + 1)``, ``lo = max(1, N // 4)``.
    → (ids [n_req, P], budgets)."""
    rng = np.random.default_rng(0)
    cyc = fsm_cycle(SERVE_CYCLE, V)
    ids, budgets = [], []
    lo = max(1, new_tokens // 4)
    for i in range(n_req):
        row = rng.integers(1, V, (1, prompt_len))
        if struct:
            row[0, -len(cyc):] = cyc
        ids.append(row[0])
        budgets.append(lo + i % (new_tokens - lo + 1))
    return np.stack(ids), budgets


def _serve_shape(args):
    """(requests, slots, prompt, new tokens) of serve; serve_sla takes its requests from ``--sla_reqs``."""
    if args.tiny:
        return args.serve_reqs or 8, args.slots or 4, 8, 8
    return args.serve_reqs or 64, args.slots or 16, args.serve_prompt, args.serve_new


def _slot_engine(args, params: Optional[dict], n_req: int, *, track_metrics: bool, guard: float):
    """The serving modes' engine and requests: (engine, [(embeds, mask, ids)], budgets, shape)."""
    cfg = text_config(args)
    text = _text_of(params) if params is not None else text_params(args)
    dev = _device_of(text)
    _, slots, P, N = _serve_shape(args)
    struct = args.serve_struct or args.serve_spec
    constraint = cycle_table(fsm_cycle(SERVE_CYCLE, cfg.vocab_size), cfg.vocab_size, dev) if struct else None
    gen_cfg = GenerationConfig(max_new_tokens=N, eos_token_id=None, pad_token_id=0,
                               kv_dtype=None if args.tiny else "int8")
    eng = slots_mod.SlotEngine(text, cfg, gen_cfg, num_slots=slots, max_len=P + N, decode_chunk=4,
                               speculative=args.serve_spec, constraint=constraint, spec_min_gain=guard,
                               track_metrics=track_metrics)
    ids, budgets = serve_workload(cfg.vocab_size, n_req, P, N, struct)
    with torch.inference_mode():
        embeds = qwen3.embed_tokens(text, torch.from_numpy(ids).to(dev))
    mask = np.ones((1, P), np.int32)
    prompts = [(embeds[i:i + 1], mask, ids[i:i + 1].astype(np.int32)) for i in range(n_req)]
    return eng, prompts, budgets, dict(slots=slots, prompt=P, new_tokens=N, struct=struct, spec=args.serve_spec)


def _submit(eng, prompts, budgets, i: int):
    e, m, lids = prompts[i]
    return eng.submit_embeds(e, m, max_new_tokens=budgets[i], lookup_ids=lids if eng.speculative else None)


def _label(shape: dict) -> str:
    return ("structured+spec" if shape["struct"] and shape["spec"] else "structured" if shape["struct"]
            else "spec" if shape["spec"] else "free")


def serve_mode(args, params: Optional[dict] = None) -> dict:
    """The root ``serve_mode``: the slot engine (text-only Qwen3-4B, W8, int8
    KV, decode chunk 4) serving ``--serve_reqs`` requests of prompt 32 with
    budgets cycled over [8, 32] on ``--slots`` slots, all submitted at once;
    after a closed warm-up pass of 4·slots requests. Requests/s = requests /
    the wall from the first submit to the last result (one timed pass, after
    the warm-up pass). Every reported count covers the timed pass alone: the
    engine's stats are reset after the warm-up and its speculative chunks
    restored with an empty guard window (the root resets only some counts);
    ``warmup_admit_dispatches`` counts the warm-up's admission prefills."""
    n_req = _serve_shape(args)[0]
    guard = 0.0 if args.spec_guard == 0 else 1.35
    eng, prompts, budgets, shape = _slot_engine(args, params, n_req, track_metrics=False, guard=guard)
    warm = [_submit(eng, prompts, budgets, i) for i in range(min(n_req, 4 * shape["slots"]))]
    eng.run_until_idle()
    for f in warm:
        f.result(timeout=600)
    st = eng.stats
    warm_dispatches = st.admit_dispatches
    st.reset()
    eng.reset_speculation()
    t = time.perf_counter()
    futs = [_submit(eng, prompts, budgets, i) for i in range(n_req)]
    eng.run_until_idle()
    results = [f.result(timeout=120) for f in futs]
    dt = time.perf_counter() - t
    return dict(mode="serve", metric="served_requests_per_sec", value=n_req / dt, unit="req/s", label=_label(shape),
                requests=n_req, **shape, wall_s=dt, served_tok_s=st.tokens / dt, chunks=st.chunks,
                admitted_mid_decode=st.admitted_mid_decode, admit_dispatches=st.admit_dispatches,
                warmup_admit_dispatches=warm_dispatches,
                mean_admission_wait_ms=st.admission_wait_s / max(st.requests, 1) * 1e3,
                kv_occupancy=st.kv_utilization, row_len=eng._row_len, spec_blocks=st.spec_blocks,
                spec_accepted=st.spec_accepted, spec_disabled_at=st.spec_disabled_at,
                tokens=[np.asarray(tok).tolist() for tok, _ in results], **_card(_device_of(eng.params)))


def serve_sla_mode(args, params: Optional[dict] = None) -> dict:
    """The root ``serve_sla_mode``: the serve engine with ``track_metrics``;
    two closed passes of min(requests, 4·slots) (the second gives the
    capacity), then Poisson arrivals (``default_rng(7)``) at ``--sla_loads``
    × the capacity, ``--sla_reqs`` requests each, served by the engine's own
    thread (``start``/``stop``): TTFT, admission wait and inter-token latency
    at p50/p99 from ``req_meta``. The metric is p99 TTFT at 1.0× (the last
    load's if 1.0 is not among them). The engine's stats are reset after the
    closed passes and its speculative chunks restored with an empty guard
    window, so the counts cover the loads alone: ``admit_dispatches`` counts
    the loads' admission prefills, ``closed_admit_dispatches`` the closed
    passes'."""
    n_req = args.sla_reqs or (8 if args.tiny else 96)
    eng, prompts, budgets, shape = _slot_engine(args, params, n_req, track_metrics=True,
                                                guard=0.0 if args.serve_spec else 1.35)
    closed = min(n_req, 4 * shape["slots"])
    tokens = {}

    def closed_pass():
        t = time.perf_counter()
        futs = [_submit(eng, prompts, budgets, i) for i in range(closed)]
        eng.run_until_idle()
        for i, f in enumerate(futs):
            tokens.setdefault(i, np.asarray(f.result(timeout=300)[0]).tolist())
            eng.req_meta.pop(f, None)
        return time.perf_counter() - t

    cold = closed_pass()
    cap = closed / closed_pass()
    closed_dispatches = eng.stats.admit_dispatches
    eng.stats.reset()
    eng.reset_speculation()
    arrivals = np.random.default_rng(7)
    loads, p99_at_1 = [], None
    eng.start()
    try:
        for load in (float(x) for x in args.sla_loads.split(",")):
            lam = max(cap * load, 1e-3)
            gaps = arrivals.exponential(1.0 / lam, size=n_req)
            futs = []
            t = time.perf_counter()
            for i in range(n_req):
                time.sleep(float(gaps[i]))
                futs.append(_submit(eng, prompts, budgets, i))
            out = [f.result(timeout=600) for f in futs]
            dt = time.perf_counter() - t
            metas = [eng.req_meta.pop(f) for f in futs]
            ttft = np.array([(m["first_tok"] - m["submit"]) * 1e3 for m in metas])
            wait = np.array([(m["admit"] - m["submit"]) * 1e3 for m in metas])
            itl = np.array([(m["done"] - m["first_tok"]) / max(m["n"] - 1, 1) * 1e3
                            for m in metas if m.get("n", 0) > 1])
            row = dict(load=load, rate=lam, requests=n_req, wall_s=dt, req_s=n_req / dt,
                       ttft_p50_ms=float(np.percentile(ttft, 50)), ttft_p99_ms=float(np.percentile(ttft, 99)),
                       wait_p50_ms=float(np.percentile(wait, 50)), wait_p99_ms=float(np.percentile(wait, 99)),
                       itl_p50_ms=float(np.percentile(itl, 50)) if itl.size else None,
                       itl_p99_ms=float(np.percentile(itl, 99)) if itl.size else None,
                       tokens=[np.asarray(tok).tolist() for tok, _ in out])
            loads.append(row)
            if abs(load - 1.0) < 1e-6:
                p99_at_1 = row["ttft_p99_ms"]
    finally:
        eng.stop()
    if p99_at_1 is None:
        p99_at_1 = loads[-1]["ttft_p99_ms"]
    return dict(mode="serve_sla", metric="serve_sla_p99_ttft_ms", value=p99_at_1, unit="ms", label=_label(shape),
                **shape, capacity_req_s=cap, cold_pass_s=cold, loads=loads,
                admit_dispatches=eng.stats.admit_dispatches, closed_admit_dispatches=closed_dispatches,
                requests_served=eng.stats.requests, closed_tokens=[tokens[i] for i in range(closed)],
                **_card(_device_of(eng.params)))


def ring_inputs(args, dev):
    """q, k, v ``[1, views·tokens, NH, D]`` bf16 from ``default_rng(0)``
    normals: 1029 tokens a view, 16 heads of 64 (tiny: 36, 4 of 16)."""
    views = args.ring_views or (2 if args.tiny else 32)
    T = views * (36 if args.tiny else 1029)
    NH, D = (4, 16) if args.tiny else (16, 64)
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(size=(1, T, NH, D))).to(dev, torch.bfloat16) for _ in range(3)]


def ring_mode(args, reps: Optional[int] = None) -> dict:
    """The root ``ring_mode`` at the 32-view VGGT global-attention shape
    ``[1, 32·1029, 16, 64]`` bf16: the direct flash forward (least of 3,
    synchronised), the two-chunk logsumexp merge (two flash forwards with lse
    over the halves of the keys, ``ring_attention.merge_chunks``) and
    ``ring_attention_sharded`` over a one-rank group (NCCL on the card, gloo
    on the CPU, on an in-process store), each held to the direct output:
    max |Δ| under 0.05 × its largest |value| or the mode raises."""
    dev = resolve_device(args.device)
    q, k, v = ring_inputs(args, dev)
    with torch.inference_mode():
        wall, direct = _least(lambda: flash_attention(q, k, v), dev, _reps(3, reps))
        h = k.shape[1] // 2
        halves = [flash_attention_with_lse(q, k[:, a:b], v[:, a:b]) for a, b in ((0, h), (h, k.shape[1]))]
        merged = ring_attention.merge_chunks([o for o, _ in halves], [l for _, l in halves], q.dtype)
        with ring_attention.single_rank_group(dev) as group:
            ring = ring_attention.ring_attention_sharded(q, k, v, group=group)
    ref = direct.float()
    diff_merge = (merged.float() - ref).abs().max().item()
    diff_ring = (ring.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    res = dict(mode="ring", metric="ring_32view_flash_ms", value=wall * 1e3, unit="ms",
               shape=list(q.shape), views=q.shape[1] // (36 if args.tiny else 1029), merge_max_abs_diff=diff_merge,
               ring_max_abs_diff=diff_ring, output_scale=scale,
               ok=diff_merge < 0.05 * scale and diff_ring < 0.05 * scale, **_card(dev))
    return res


MODE_FNS = dict(e2e=e2e_mode, qa=qa_mode, spec=spec_mode, serve=serve_mode, serve_sla=serve_sla_mode, ring=ring_mode)


def describe(res: dict) -> str:
    """The figures of a mode's result on one line."""
    m = res["mode"]
    where = f"on {res['kind']} ({res['card']})"
    if m == "e2e":
        curve = ", ".join(f"{k} → {c['ms']:.1f} ms ({c['steps']} steps)" for k, c in res["early_exit"].items())
        return (f"e2e [{res['quant']}]: {res['value']:.1f} ms a query; TTFT {res['ttft_ms']:.1f} ms; decode tail "
                f"{res['decode_tokens']} tok × {res['decode_ms_per_token']:.2f} ms; early exit {curve}; {where}")
    if m == "qa":
        return (f"qa [{res['quant']}, vision {res['vquant']}]: B={res['batch']} in {res['wall_s']:.3f} s → "
                f"{res['value']:.2f} samples/s; {where}")
    if m == "spec":
        r = res["runs"]
        line = (f"spec k={res['draft_k']} [{res['quant']}, kv {res['kv']}]: JSON-structured speedup "
                f"{res['value']:.2f}× ({r['generate_constrained']['ms']:.1f} → "
                f"{r['speculative_constrained']['ms']:.1f} ms, {r['speculative_constrained']['iterations']} "
                f"iterations for {res['new_tokens']} tokens); "
                f"worst-case overhead {res['worst_case_overhead']:.2f}× ({r['generate_free']['ms']:.1f} → "
                f"{r['speculative_free']['ms']:.1f} ms, {r['speculative_free']['iterations']} iterations)")
        if "action_speedup" in res:
            line += (f"; action query {res['action_tokens']} tokens {r['action_plain']['ms']:.1f} → "
                     f"{r['action_speculative']['ms']:.1f} ms ({res['action_speedup']:.2f}×, "
                     f"{r['action_speculative']['iterations']} iterations)")
        return f"{line}; {where}"
    if m == "serve":
        spec = (f"; spec blocks {res['spec_blocks']}, accepted {res['spec_accepted']}, guard tripped at chunk "
                f"{res['spec_disabled_at']}" if res["spec"] else "")
        return (f"serve [{res['label']}]: {res['requests']} requests × {res['new_tokens']} tokens over {res['slots']} "
                f"slots in {res['wall_s']:.2f} s → {res['value']:.2f} req/s, {res['served_tok_s']:.0f} served tok/s, "
                f"{res['chunks']} chunks, {res['admitted_mid_decode']} mid-decode admissions, "
                f"{res['admit_dispatches']} admit dispatches (mean admission wait {res['mean_admission_wait_ms']:.0f} ms), KV occupancy "
                f"{100 * res['kv_occupancy']:.0f}% (reserved {res['slots']}×{res['row_len']}){spec}; {where}")
    if m == "serve_sla":
        loads = "; ".join(
            f"{r['load']:.1f}× (λ={r['rate']:.2f}/s): {r['req_s']:.2f} req/s, TTFT p50 {r['ttft_p50_ms']:.0f} / p99 "
            f"{r['ttft_p99_ms']:.0f} ms, wait p50 {r['wait_p50_ms']:.0f} / p99 {r['wait_p99_ms']:.0f} ms, "
            f"inter-token p50 {_ms(r['itl_p50_ms'])} / p99 {_ms(r['itl_p99_ms'])} ms" for r in res["loads"])
        return (f"serve_sla [{res['label']}]: capacity {res['capacity_req_s']:.2f} req/s (cold pass "
                f"{res['cold_pass_s']:.2f} s); {loads}; {where}")
    return (f"ring: {res['views']} views {res['shape']} flash forward {res['value']:.3f} ms; two-chunk merge max|Δ| "
            f"{res['merge_max_abs_diff']:.2e}, one-rank ring max|Δ| {res['ring_max_abs_diff']:.2e} (output scale "
            f"{res['output_scale']:.2f}); {where}")


def _ms(x) -> str:
    return "n/a" if x is None else f"{x:.1f}"


BULKY = ("tokens", "first_token", "early_exit_tokens", "closed_tokens")


def summary(res: dict) -> dict:
    """A mode's result without its tokens (the JSON line)."""
    out = {k: v for k, v in res.items() if k not in BULKY}
    if "runs" in out:
        out["runs"] = {k: {n: x for n, x in r.items() if n != "tokens"} for k, r in out["runs"].items()}
    if "loads" in out:
        out["loads"] = [{n: x for n, x in r.items() if n != "tokens"} for r in out["loads"]]
    return out


def mode_main(args) -> dict:
    res = MODE_FNS[args.mode](args)
    print(describe(res), flush=True)
    print(json.dumps(summary(res)), flush=True)
    if args.mode == "ring" and not res["ok"]:
        raise SystemExit("ring: the merge or the one-rank ring is out of tolerance against the direct forward")
    return res


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mode == "train":
        return train_main(args)
    if args.mode in MODE_FNS:
        return mode_main(args)
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
