#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--max_new_tokens 32]
    python3 chip_smoke.py --tiles flash_bwd|decode_matmul [--package_root DIR]
    python3 chip_smoke.py --w8_gemm [--package_root DIR]

Run from the root of a checkout. It:

1. prints the card (name, ``nvidia-smi`` power limit);
2. builds the five CUDA sources of the port from ``vggt_qwen3_tpu_torch/csrc``
   (flash forward, the two flash backward kernels, decode attention,
   block-verify attention, the four W8 decode kernels) with ``nvcc`` for
   sm_90a, in parallel, prints the ptxas report and fails on a spill in the
   sources redesigned for Hopper (``TILES``: flash_bwd, decode_matmul);
3. holds each kernel against its plain PyTorch version at its main path's
   shapes (``utils.agreement``, tol 2e-2 scaled to the reference: every
   element within 2e-2·max|ref| + 2e-2·|ref|, and ‖err‖₂ ≤ 5e-3·‖ref‖₂; rows
   with no valid key exactly 0; the W8 head: the same token on every row
   whose top-2 gap exceeds 1e-4·max|logit|, at least 99 % of the rows),
   timing on the device (``torch.profiler``) the kernel, the plain version
   and one PyTorch library call that computes the same function
   (``scaled_dot_product_attention``; ``torch.mm`` over a bf16 copy of the
   W8 weight dequantized outside the timed region — timed only as
   yardsticks, the port never calls them), and the wrapper's call with CUDA
   events (host included). Kernels that read a stacked per-layer tensor are
   timed with the layer index turning over the layers, so each launch reads
   a layer the one before did not, as in a decode step;
   The block-verify kernel runs at the ARKit verify shape (q [4, 7, 32, 128]
   over [36, 4, 8, 832, 128]) with bf16 and int8 caches, ragged starts and
   offsets, a row whose first queries see no slot (exactly 0) and 1e4 in
   every slot no query sees. The W8 layer kernels run at the bench shape
   (368 rows) and QKV and WO also at 8 rows (the QA path's W8 decode step),
   the MLP's two launches timed apart (gate/up; the down w8_gemm, beside
   ``torch.mm`` for the down projection alone), two launches of each on the
   same inputs equal bit for bit; the kernel's cut of each w8_gemm launch
   (``w8_gemm_plan``) and the bounds of the MLP's two launches and of the
   8-row shapes are printed on a line of their own. The flash backward
   kernels (dq; dk/dv) and the
   forward's lse output run at the training shapes — VGGT frame
   [16, 1029, 16, 64] and global [2, 8232, 16, 64] — and at a causal,
   left-padded GQA shape [2, 512, 32/8, 128], with 1e4 in every K/V slot
   outside a row's frontier; query rows with no key and keys no query sees
   get exactly 0, and a second run on the same inputs must give dq, dk and
   dv bit for bit (no atomics); the library time there is SDPA's backward
   kernels, printed by name, and a line of its own gives the bounds beside
   the floor of the exponentials (one a valid score, 16 a clock per SM at
   the card's highest SM clock, ``nvidia-smi``);
4. holds small-width models run on the card (kernels) against the same runs
   on the CPU (plain versions): bf16; W8 with an int8 cache; and
   speculative decoding under the action-JSON constraint with an int8 cache
   (tokens equal on every row whose every step has a top-2 gap above
   1e-4·max|logit|); and the training step (bf16, the tower unfrozen, 4 micro
   steps at grad_accum 2: losses, grad norms, the vision gradients, the
   updates), then saves and restores that train state and checks the next
   steps;
5. drives the QA path at full width — Qwen3-4B, VGGT-1B, the perceiver_small
   projector, 8 samples × 8 views × 448², random weights from ``--seed`` —
   through ``inference.qa.run_inference`` with the bf16 cache (the CLI
   default, "the main path") and with the int8 cache, with every launch
   counter set to 0 just before and read just after each run, and repeats
   each run to check the tokens are identical; then once with W8 weights
   (``quantize=True``), and once more with qkvo LoRA adapters on the W8
   weights (the fused MLP still runs; QKV and WO take the plain product);
6. drives the W8 decode path at full width through
   ``vggt_qwen3_tpu_torch.bench`` (Qwen3-4B, W8 weights, int8 cache,
   B=368, prompt 32, 128 greedy steps): tokens/s, the decode step, peak
   memory, the launch counts of one timed ``generate`` (counters set to 0
   just before it), tokens identical on the repeat, and a profile by kernel
   family;
7. drives the ARKit action-JSON path at full width through
   ``inference.arkit.run_inference`` on the stage of
   ``configs/stage2_arkit.yaml`` (Qwen3-4B, VGGT-1B, perceiver_small; the 4
   ARKit test scenes, 10 seeded views each, preprocessed to 448²; batch 4,
   random weights from ``--seed``, byte tokenizer) with the
   constraint FSM, once without speculative decoding (decode attention 36 ×
   steps) and twice with it (block verify 36 × iterations, decode attention
   0), counters set to 0 just before and read just after each run; the
   repeat must give the same records, every generation must parse to the
   schema's five keys, and where the speculative tokens differ from the
   plain run's, the plain run's top-2 gap at the first differing step must
   be a near-tie: under 1e-3·max|logit|, or under twice the logit
   difference the two schedules show on the same tokens with no kernel of
   the path in them (six one-token steps against one 7-token verify block,
   bf16 GEMMs at 4 rows against 28, both with the plain attention versions
   on the card); the same verify block with the kernel holds each layer's
   kernel call to the plain version on its inputs; then a profile of one
   speculative run cut at 128 new tokens;
8. drives the SFT training path at full width through the trainer's entry
   points on the stage of ``configs/stage1_3d.yaml`` (``train_stage``: 6.18 B
   params, LoRA r16 on qkvo, text layers 0-3 frozen; 2 rows a micro step,
   grad_accum 2, a 4-step schedule; ScanQA/SQA3D placeholder records with
   seeded views, view dropout 0.3, Perceiver dropout 0.1): the recipe as
   shipped (tower frozen) for 2 micro steps, then ``freeze_vision`` false for
   4 (2 updates), asserting the launches of every micro step (72 flash
   forwards frozen; 144 forwards, 72 dq and 72 dk/dv unfrozen — the forward
   and its recompute), finite losses, frozen leaves bit-identical, and every
   trainable leaf changed unless its update is under half a bf16 ulp
   everywhere; micro-step wall time, tokens/s, peak memory and a profile of
   one micro step with its update;
9. prints the kernels line, the card line and, last, the ok line.

Any failure raises and the script exits non-zero. Without a CUDA device, or
outside a checkout of the repo, it exits non-zero before printing a result.

With ``--tiles SOURCE`` it runs only the checks of step 3 that time the
kernels of ``csrc/SOURCE.cu``, once for each build in ``TILES[SOURCE]``
(tile, ring and cut sizes set with nvcc defines), the source's own first and
last so that the spread of the call shows beside the differences:
``flash_bwd`` runs the flash backward at its three shapes, ``decode_matmul``
the W8 layer kernels (QKV and WO at 368 and 8 rows, the MLP's two launches;
no head). ``--w8_gemm`` is the latter with the source's own build alone.
``--package_root DIR`` imports the port from DIR instead (another tree, such
as the parent commit unpacked with ``git archive``), so that two trees are
timed on one card: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak
H100_SMS = 132
H100_EXP_PER_SM_CLOCK = 16   # ex2 on the special function units: 4 quadrants x 4 a clock
FLASH_REPLACES = "vggt_qwen3_tpu/ops/flash_attention.py:41"
DECODE_REPLACES = "vggt_qwen3_tpu/ops/decode_attention.py:55"
VERIFY_REPLACES = "vggt_qwen3_tpu/ops/decode_attention.py:317"
ARKIT_SCENES = "data/processed/arkit_synth/test.json"
SCHEMA_KEYS = ["action", "scene", "center", "normal", "extent"]
DRAFT_K = 6  # generate_batch's default verify block: k + 1 = 7 queries
ARKIT_NEW_TOKENS = 340  # every constrained object closes within 340 byte tokens
ARKIT_PROFILE_TOKENS = 128
BWD_SOURCE = "vggt_qwen3_tpu_torch/csrc/flash_bwd.cu"
BWD_REPLACES = {"flash_bwd_dq": "vggt_qwen3_tpu/ops/flash_attention.py:363",
                "flash_bwd_dkv": "vggt_qwen3_tpu/ops/flash_attention.py:435"}
TRAIN_BATCH, TRAIN_GRAD_ACCUM, TRAIN_MAX_STEPS = 2, 2, 4
# other tile and ring sizes of csrc/flash_bwd.cu at D = 64, as the nvcc
# defines it reads (its own: 128 queries and 3 stages for dk/dv, 128 keys and
# 3 stages for dq)
FLASH_BWD_TILES = {
    "dkv_64_queries": {"DKV_QUERIES": 64},
    "dkv_2_stages": {"DKV_STAGES": 2},
    "dkv_4_stages": {"DKV_STAGES": 4},
    "dq_64_keys": {"DQ_KEYS": 64},
    "dq_2_stages": {"DQ_STAGES": 2},
}
# other cuts of w8_gemm (csrc/decode_matmul.cu), as the nvcc defines it
# reads (its own, gemm_plan there: K parts of at most 10 steps for row groups
# of up to 64 rows; wider groups in 4 parts, or in one with groups of at most
# 80 rows when K has fewer than 48 steps)
W8_GEMM_TILES = {
    "one_part_rows_96": {"W8_ONE_PART_ROWS": 96},
    "one_part_rows_64": {"W8_ONE_PART_ROWS": 64},
    "wide_parts_2": {"W8_WIDE_PARTS": 2},
    "wide_parts_8": {"W8_WIDE_PARTS": 8},
    "small_part_steps_5": {"W8_SMALL_PART_STEPS": 5},
    "small_part_steps_20": {"W8_SMALL_PART_STEPS": 20},
}
W8_SOURCE = "vggt_qwen3_tpu_torch/csrc/decode_matmul.cu"
W8_REPLACES = {
    "fused_qkv_w8": "vggt_qwen3_tpu/ops/decode_matmul.py:180",
    "fused_linear_w8": "vggt_qwen3_tpu/ops/decode_matmul.py:283",
    "fused_mlp_w8": "vggt_qwen3_tpu/ops/decode_matmul.py:44",
    "fused_head_argmax": "vggt_qwen3_tpu/ops/decode_matmul.py:345",
}


def full_stage():
    """The stage ``configs/stage1_3d.yaml`` resolves to, built from the presets
    (no YAML reader needed): Qwen3-4B, VGGT-1B, perceiver_small, 128 vision
    tokens, 8 views, 448²."""
    from vggt_qwen3_tpu_torch.config import (
        QWEN3_4B_INSTRUCT_2507, VGGT_1B, DataConfig, PerceiverConfig, StageConfig, TrainConfig, VLMConfig,
    )

    model = VLMConfig(
        text=QWEN3_4B_INSTRUCT_2507, vision=VGGT_1B,
        projector=PerceiverConfig(latent_dim=4096, num_latents=128, num_heads=8, num_layers=6,
                                  ffn_dim=16384, dropout=0.1),
        num_vis_tokens=128, geom_tokens=8, freeze_vision=True, vision_backbone="vggt", dtype="bfloat16",
    )
    data = DataConfig(
        datasets={"scanqa": "data/processed/scanqa/train_split.jsonl",
                  "sqa3d": "data/processed/sqa3d/train_split.jsonl"},
        mix_ratio={"scanqa": 0.7, "sqa3d": 0.3},
        num_views=8, image_size=448, max_length=512, view_dropout=0.3,
    )
    return StageConfig(model=model, data=data, train=TrainConfig())


def train_stage():
    """The stage ``configs/stage1_3d.yaml`` gives the trainer, built from the
    presets (LoRA r16 on qkvo, text layers 0-3 frozen, the recipe's optimizer),
    reduced for the chip check: 2 rows a micro step (the recipe has 6),
    ``grad_accum`` 2 (32) and a schedule horizon of 4 micro steps (30,000), so
    that the second update runs at the peak learning rate (the first runs at
    the warmup's 0)."""
    import dataclasses

    from vggt_qwen3_tpu_torch.config import LoRAConfig, TrainConfig

    return dataclasses.replace(
        full_stage(),
        train=TrainConfig(precision="bf16", optimizer="adamw", lr=5e-6, proj_lr=1e-4, weight_decay=0.1,
                          warmup_ratio=0.03, batch_size_per_device=TRAIN_BATCH, grad_accum=TRAIN_GRAD_ACCUM,
                          max_steps=TRAIN_MAX_STEPS, save_every_steps=1500, eval_every_steps=3000,
                          log_every_steps=20, gradient_clip=1.0, seed=42),
        lora=LoRAConfig(enable=True, rank=16, alpha=32, dropout=0.05,
                        target_modules=("q_proj", "k_proj", "v_proj", "o_proj")),
        freeze_text_layers=(0, 1, 2, 3),
    )


class SeededViews:
    """The records of a placeholder split with seeded uint8 views of the
    placeholders' size in place of their image files (no image decoder
    needed), padded to ``num_views`` by repeating the last view as the
    port's reader does."""

    def __init__(self, path, num_views: int, seed: int, side: int = 96):
        self.records = [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]
        self.num_views, self.seed, self.side = num_views, seed, side

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        r = self.records[i]
        rng = np.random.default_rng([self.seed, i])
        n = min(len(r["images"]), self.num_views)
        views = [rng.integers(0, 256, (self.side, self.side, 3), dtype=np.uint8) for _ in range(n)]
        views += [views[-1]] * (self.num_views - n)
        return dict(images=views, geom_token=r.get("geom_token"), question=r["question"], answer=r["answer"],
                    task=r.get("task"), scene_id=r.get("scene_id"))


def seeded_datasets(stage, seed: int):
    return {name: SeededViews(REPO / glob, stage.data.num_views, seed) for name, glob in stage.data.datasets.items()}


def arkit_stage():
    """The stage ``configs/stage2_arkit.yaml`` resolves to, built from the
    presets (no YAML reader needed): Qwen3-4B, VGGT-1B, the first 96 VGGT
    tokens resampled to perceiver_small's 128 latents, 10 views, 448²."""
    import dataclasses

    from vggt_qwen3_tpu_torch.config import DataConfig

    qa = full_stage()
    return dataclasses.replace(
        qa, model=dataclasses.replace(qa.model, num_vis_tokens=96),
        data=DataConfig(datasets={"arkit_synth": "data/processed/arkit_synth/*.json"},
                        mix_ratio={"arkit_synth": 1.0}, num_views=10, image_size=448, max_length=4096,
                        view_dropout=0.2))


def load_arkit_samples(seed: int, n_views: int = 10, side: int = 96):
    """The 4 ARKit test scenes (instruction, reference action, scene), each
    with ``n_views`` seeded uint8 views of the placeholders' size, in the
    form ``arkit.load_arkit_samples`` gives them (no image decoder needed)."""
    records = json.loads((REPO / ARKIT_SCENES).read_text())
    rng = np.random.default_rng(seed)
    return [dict(question=r["instruction"], answer=r["action_json"], scene_id=r["scene_id"], task=r["task"],
                 geom_token=r["geom_token"],
                 images=[rng.integers(0, 256, (side, side, 3), dtype=np.uint8) for _ in range(n_views)])
            for r in records]


def load_samples(seed: int, n_views: int = 8, side: int = 96):
    """The 8 ScanQA test questions, each with ``n_views`` seeded uint8 views
    of the placeholders' size."""
    path = REPO / "data" / "processed" / "scanqa" / "test_split.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    rng = np.random.default_rng(seed)
    return [dict(r, images=[rng.integers(0, 256, (side, side, 3), dtype=np.uint8) for _ in range(n_views)])
            for r in records]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def host_ms(fn, iters: int, repeats: int = 5) -> float:
    """Host time of one call of ``fn``: the host clock over ``iters`` calls
    issued back to back without waiting for the device (the launch queue
    holds them), so that the device's time does not enter it; the least of
    ``repeats`` such batches (a shared host's other work only adds time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t)
        torch.cuda.synchronize()
    return best * 1e3 / iters


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' durations as
    ``torch.profiler`` records them, over ``iters`` calls. Unlike
    :func:`cuda_ms` it leaves out the host's time between launches, which is
    what a back-to-back loop of a short kernel measures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    by = device_ms_by_kernel(fn, iters)
    return sum(by.values())


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def held_to_plain(what: str, got, ref) -> dict:
    """The kernel's output against its plain version's, by the limits of
    ``utils.agreement``; raises if they disagree, else returns the errors
    beside their limits."""
    from vggt_qwen3_tpu_torch.utils.agreement import agreement

    out = agreement(got, ref)
    if not out.pop("ok"):
        raise AssertionError(f"{what} disagrees with its plain version: {out}")
    return out


def check_flash(name, B, S, T, NH, NKV, D, *, causal, starts, gen):
    """Kernel vs plain at one shape; returns the measurement dict."""
    import torch
    import torch.nn.functional as F

    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    q = torch.randn(B, S, NH, D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, T, NKV, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, T, NKV, D, device="cuda", generator=gen).bfloat16()
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    end = torch.full((B,), T, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, kv_start=start, kv_end=end)

    def plain():
        # the plain version materialises f32 scores: above 8 GiB of them it
        # runs one batch row at a time (the VGGT global shape, B=8: 35 GB)
        if B * NH * S * T * 4 <= 2**33:
            return fa.flash_attention_plain(q, k, v, **kw)
        return torch.cat([fa.flash_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal,
                                                   kv_start=start[b:b + 1], kv_end=end[b:b + 1])
                          for b in range(B)])

    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = plain()
    live = torch.ones(B, S, dtype=torch.bool, device="cuda")
    for b, s0 in enumerate(starts):
        if causal:
            live[b, :s0] = False
    agree = held_to_plain(f"flash_fwd[{name}]", got[live], ref[live])
    if (~live).any() and got[~live].abs().max().item() != 0.0:
        raise AssertionError(f"flash_fwd[{name}]: rows with no valid key are not 0")
    del ref
    pos = torch.arange(T, device="cuda")
    mask = (pos[None, :] >= start[:, None])[:, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= torch.arange(S, device="cuda")[:, None])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = (lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=NH != NKV)) \
        if (causal or any(starts)) else (lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=NH != NKV))
    call_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), iters=10)
    ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw), iters=10)
    plain_ms = device_ms(plain, iters=2)
    library_ms = device_ms(lib, iters=10)
    # work this data needs: valid (query, key) pairs only
    if causal:
        pairs = sum((S - s0) * (S - s0 + 1) // 2 for s0 in starts)
    else:
        pairs = sum(S * (T - s0) for s0 in starts)
    flops = 4 * NH * D * pairs
    nbytes = 2 * (2 * B * S * NH * D + 2 * B * T * NKV * D)
    bms, by = bound_ms(nbytes, flops)
    out = dict(shape=f"{name} q[{B},{S},{NH},{D}] kv[{B},{T},{NKV},{D}] causal={causal}",
               **agree, ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bms, bound_by=by)
    print(f"flash_fwd {json.dumps(out)}", flush=True)
    return out


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Device time of one call of ``fn`` by kernel name (``torch.profiler``).
    A profiler session now and then records no device activity at all (after
    many sessions in one process); such a session is run again, twice at
    most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        if by:
            return by
    raise AssertionError("the profiler saw no device time")


def check_flash_backward(name, B, S, NH, NKV, D, *, causal, starts, ends, gen):
    """Kernels 8 and 9 (and kernel 1's lse output) against their plain
    versions at one shape (S = T), with 1e4 in every K/V slot outside a row's
    frontier; query rows with no valid key must get exactly 0. The plain
    versions materialise [S, T] f32 scores, so they run one kv head (its GQA
    group of query heads) at a time. Returns the measurements of dq and
    dk/dv: device ms by kernel, the plain backward's and SDPA's backward
    kernels' device ms (each the whole backward: dq, dk and dv together)."""
    import torch
    import torch.nn.functional as F

    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    G = NH // NKV
    q = torch.randn(B, S, NH, D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, S, NKV, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, S, NKV, D, device="cuda", generator=gen).bfloat16()
    d_out = torch.randn(B, S, NH, D, device="cuda", generator=gen).bfloat16()
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    end = torch.tensor(ends, dtype=torch.int32, device="cuda")
    pos = torch.arange(S, device="cuda")
    outside = (pos[None] < start[:, None]) | (pos[None] >= end[:, None])  # [B, S]
    k.masked_fill_(outside[:, :, None, None], 1e4)
    v.masked_fill_(outside[:, :, None, None], 1e4)
    kw = dict(causal=causal, kv_start=start, kv_end=end)

    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, start, end, out, lse, d_out, causal=causal)
    again = fa.flash_attention_backward(q, k, v, start, end, out, lse, d_out, causal=causal)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):  # no atomics: a fixed order of sums
        raise AssertionError(f"flash_bwd[{name}]: two runs on the same inputs differ")
    del again

    def plain(with_fwd=False):
        res = []
        for h in range(NKV):
            hs = slice(h * G, (h + 1) * G)
            args = (q[:, :, hs], k[:, :, h:h + 1], v[:, :, h:h + 1])
            if with_fwd:
                res.append(fa.flash_attention_plain_with_lse(*args, **kw))
            else:
                res.append(fa.flash_attention_backward_plain(*args, start, end, out[:, :, hs], lse[:, hs],
                                                             d_out[:, :, hs], causal=causal))
        return res

    ref_lse = torch.cat([r[1] for r in plain(with_fwd=True)], dim=1)
    live = ref_lse > -1e29
    lse_err = (lse[live] - ref_lse[live]).abs().max().item()
    if lse_err > 1e-3 or not (lse[~live] == -1e30).all():
        raise AssertionError(f"flash_fwd lse[{name}]: max abs err {lse_err}, or a dead row not -1e30")
    ref = plain()
    ref_dq = torch.cat([r[0] for r in ref], dim=2)
    ref_dk = torch.cat([r[1] for r in ref], dim=2)
    ref_dv = torch.cat([r[2] for r in ref], dim=2)
    del ref
    agree = {n: held_to_plain(f"flash_bwd {n}[{name}]", a, r)
             for n, a, r in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
    del ref_dq, ref_dk, ref_dv
    dead = ~live.any(1)  # [B, S]: no head of the row sees a key
    if dead.any() and dq[dead].abs().max().item() != 0.0:
        raise AssertionError(f"flash_bwd dq[{name}]: rows with no valid key are not 0")
    if outside.any() and max(dk[outside].abs().max().item(), dv[outside].abs().max().item()) != 0.0:
        raise AssertionError(f"flash_bwd dk/dv[{name}]: keys outside the frontier are not 0")

    by = device_ms_by_kernel(lambda: fa.flash_attention_backward(q, k, v, start, end, out, lse, d_out,
                                                                 causal=causal), iters=5)
    dq_ms = sum(t for n, t in by.items() if "flash_bwd_dq" in n)
    dkv_ms = sum(t for n, t in by.items() if "flash_bwd_dkv" in n)
    delta_ms = sum(by.values()) - dq_ms - dkv_ms
    call_ms = cuda_ms(lambda: fa.flash_attention_backward(q, k, v, start, end, out, lse, d_out, causal=causal),
                      iters=5)
    fwd_ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw), iters=5)
    fwd_lse_ms = device_ms(lambda: fa.flash_attention_with_lse(q, k, v, **kw), iters=5)
    plain_ms = device_ms(plain, iters=1)
    # SDPA's backward kernels alone: the graph of one forward, differentiated repeatedly
    q_, k_, v_ = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    mask = (~outside)[:, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    o_ = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask if (causal or outside.any()) else None,
                                        enable_gqa=NH != NKV)
    g_ = d_out.transpose(1, 2)
    library_by = device_ms_by_kernel(lambda: torch.autograd.grad(o_, (q_, k_, v_), g_, retain_graph=True), iters=5)
    library_ms = sum(library_by.values())
    del o_, q_, k_, v_
    if causal:
        pairs = sum(sum(max(0, min(i + 1, e) - s) for i in range(S)) for s, e in zip(starts, ends))
    else:
        pairs = sum(S * (e - s) for s, e in zip(starts, ends))
    qbytes, kbytes, stat = 2 * B * S * NH * D, 2 * B * S * NKV * D, 4 * B * NH * S
    dq_bound, dq_by = bound_ms(3 * qbytes + 2 * kbytes + 2 * stat, 6 * NH * D * pairs)
    dkv_bound, dkv_by = bound_ms(2 * qbytes + 4 * kbytes + 2 * stat, 8 * NH * D * pairs)
    # each kernel takes one exponential per valid score, on the SMs' special
    # function units: 16 a clock per SM at the card's highest SM clock
    exp_floor = NH * pairs / (H100_SMS * H100_EXP_PER_SM_CLOCK * sm_clock_hz()) * 1e3
    shape = f"{name} q[{B},{S},{NH},{D}] kv[{B},{S},{NKV},{D}] causal={causal}"
    print(f"sdpa_backward_kernels[{name}] {json.dumps(library_by)} (whole {library_ms:.4f} ms)", flush=True)
    print(f"flash_bwd_floors[{name}] bound_ms dq {dq_bound:.4f} ({dq_by}), dkv {dkv_bound:.4f} ({dkv_by}); "
          f"exp_floor_ms {exp_floor:.4f} a kernel", flush=True)
    res = {
        "flash_bwd_dq": dict(shape=shape, **agree["dq"], ms=dq_ms, call_ms=call_ms, delta_ms=delta_ms,
                             plain_ms=plain_ms, library_ms=library_ms, bound_ms=dq_bound, bound_by=dq_by),
        "flash_bwd_dkv": dict(shape=shape, **{f"dk_{a}": b for a, b in agree["dk"].items()},
                              **{f"dv_{a}": b for a, b in agree["dv"].items()},
                              max_abs_err=max(agree["dk"]["max_abs_err"], agree["dv"]["max_abs_err"]),
                              ms=dkv_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=dkv_bound,
                              bound_by=dkv_by),
        "flash_fwd_lse": dict(shape=shape, lse_max_abs_err=lse_err, ms_with_lse=fwd_lse_ms, ms_without=fwd_ms),
    }
    for n, r in res.items():
        print(f"{n} {json.dumps(r)}", flush=True)
    del q, k, v, d_out, out, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return res


def backward_checks(stage, gen):
    """check_flash_backward at the training shapes (2 samples x 8 views) and
    at a causal left-padded GQA shape at D = 128 with query rows that see no
    key."""
    vis, txt = stage.model.vision, stage.model.text
    tpf = vis.patch_start_idx + (stage.data.image_size // vis.patch_size) ** 2  # 1029 at 448²
    B, V, D = TRAIN_BATCH, stage.data.num_views, vis.embed_dim // vis.num_heads
    return {
        "vggt_frame": check_flash_backward("vggt_frame", B * V, tpf, vis.num_heads, vis.num_heads, D, causal=False,
                                           starts=[0] * (B * V), ends=[tpf] * (B * V), gen=gen),
        "vggt_global": check_flash_backward("vggt_global", B, V * tpf, vis.num_heads, vis.num_heads, D,
                                            causal=False, starts=[0] * B, ends=[V * tpf] * B, gen=gen),
        "causal_gqa": check_flash_backward("causal_gqa_d128", 2, 512, txt.num_heads, txt.num_kv_heads, txt.head_dim,
                                           causal=True, starts=[0, 37], ends=[512, 500], gen=gen),
    }


def flash_bwd_times(stage, gen) -> dict:
    """backward_checks' device ms: {shape: (dq, dk/dv)}."""
    return {shape: (r["flash_bwd_dq"]["ms"], r["flash_bwd_dkv"]["ms"])
            for shape, r in backward_checks(stage, gen).items()}


def w8_gemm_times(stage, gen) -> dict:
    """check_w8 without the head at the bench shape: the w8_gemm figures
    (device, call and host ms of QKV and WO at 368 and 8 rows and of the
    MLP's down launch, beside torch.mm's), w8_swiglu's device ms, and each
    w8_gemm launch's plan."""
    res = check_w8(stage.model.text, 368, gen, head=False)
    q, o, m = res["fused_qkv_w8"], res["fused_linear_w8"], res["fused_mlp_w8"]
    times = {}
    for key, r in (("qkv", q), ("wo", o)):
        for pre, sub in (("", ""), ("m8_", "_m8")):
            times.update({f"{key}{sub}": r[f"{pre}ms"], f"{key}{sub}_mm": r[f"{pre}library_ms"],
                          f"{key}{sub}_call": r[f"{pre}call_ms"], f"{key}{sub}_host": r[f"{pre}host_ms"]})
    times.update(down=m["down_ms"], down_mm=m["down_library_ms"], swiglu=m["swiglu_ms"],
                 plans=res["plans_and_bounds"]["plans"])
    return times


# csrc/<source>.cu -> (its variants as nvcc defines, the check that times a build)
TILES = {"flash_bwd": (FLASH_BWD_TILES, flash_bwd_times), "decode_matmul": (W8_GEMM_TILES, w8_gemm_times)}


def ptxas_spills(lib) -> list:
    """The lines of a build's ptxas report that show a spill."""
    return [ln.strip() for ln in lib.ptxas_log.splitlines() if "spill" in ln and " 0 bytes spill stores" not in ln]


def tiles(source: str, stage, gen, variants: bool = True) -> dict:
    """TILES[source]'s check for each build of csrc/<source>.cu in its table,
    the source's own defines first and last ("own", "own (again)"); with
    ``variants`` false, the source's own build once. Fails on a ptxas spill."""
    from vggt_qwen3_tpu_torch.ops import kernel_build

    table, check = TILES[source]
    runs = [("own", {}), *table.items(), ("own (again)", {})] if variants else [("own", {})]
    times = {}
    for name, defines in runs:
        lib = kernel_build.rebuild(source, defines)
        spills = ptxas_spills(lib)
        if spills:
            raise AssertionError(f"{source} {name}: ptxas spills: {spills}")
        times[name] = check(stage, gen)
        print(f"tiles {source} {name} {json.dumps(defines)} {json.dumps(times[name])}", flush=True)
    if variants:
        kernel_build.rebuild(source, {})
    return times


def check_decode(name, L, B, NH, NKV, T, D, li, starts, *, quant, gen):
    import torch
    import torch.nn.functional as F

    from vggt_qwen3_tpu_torch.ops import decode_attention as da

    q = torch.randn(B, NH, D, device="cuda", generator=gen).bfloat16()
    if quant:
        k = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=gen, dtype=torch.int8)
        ks = (torch.rand(L, B, NKV, T, device="cuda", generator=gen) * 0.02 + 0.005).bfloat16()
        vs = (torch.rand(L, B, NKV, T, device="cuda", generator=gen) * 0.02 + 0.005).bfloat16()
    else:
        k = torch.randn(L, B, NKV, T, D, device="cuda", generator=gen).bfloat16()
        v = torch.randn(L, B, NKV, T, D, device="cuda", generator=gen).bfloat16()
        ks = vs = None
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    end = torch.full((B,), T, dtype=torch.int32, device="cuda")
    args = (q, k, v, li, start, end, ks, vs)
    got = da.gqa_decode_attention(*args)
    torch.cuda.synchronize()
    ref = da.gqa_decode_attention_plain(*args)
    agree = held_to_plain(f"decode_attention[{name}]", got, ref)
    turn = layer_turns(L)
    library_ms = None
    if not quant:  # no single library call reads an int8 cache with folded scales
        pos = torch.arange(T, device="cuda")
        mask = (pos[None, :] >= start[:, None])[:, None, None, :]
        q4 = q[:, :, None]
        library_ms = device_ms(lambda: (lambda i: F.scaled_dot_product_attention(
            q4, k[i], v[i], attn_mask=mask, enable_gqa=True))(turn()), 2 * L)
    rotating = lambda: da.gqa_decode_attention(q, k, v, turn(), start, end, ks, vs)  # noqa: E731
    call_ms = cuda_ms(rotating, iters=2 * L)
    ms = device_ms(rotating, iters=2 * L)
    ms_one_layer = device_ms(lambda: da.gqa_decode_attention(*args), iters=20)  # one fixed layer, warm in L2
    plain_ms = device_ms(lambda: da.gqa_decode_attention_plain(q, k, v, turn(), start, end, ks, vs), iters=6)
    slots = sum(T - s for s in starts)
    itemsize = 1 if quant else 2
    nbytes = 2 * slots * NKV * D * itemsize + (2 * slots * NKV * 2 if quant else 0) + 2 * 2 * B * NH * D
    bms, by = bound_ms(nbytes, 4 * NH * D * slots)
    out = dict(shape=f"{name} q[{B},{NH},{D}] cache[{L},{B},{NKV},{T},{D}] li turning over {L} layers",
               **agree, ms=ms, ms_one_layer=ms_one_layer, call_ms=call_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bms, bound_by=by)
    print(f"decode_attention {json.dumps(out)}", flush=True)
    return out


def layer_turns(L: int):
    """0, 1, …, L−1, 0, … on successive calls: the layer index of a timed
    launch, so that each launch reads a layer the one before did not (a
    decode step's order; a fixed layer would sit in L2)."""
    return itertools.cycle(range(L)).__next__


def check_verify(name, L, B, NH, NKV, T, D, S, li, starts, offs, *, quant, gen):
    """The block-verify kernel against its plain version: ragged starts and
    offsets (one row's first queries see no slot and must give exactly 0),
    and 1e4 in every slot no query of a row sees, so a kernel that reads
    past a frontier disagrees. Timed with the layer index turning; the
    yardstick is SDPA over layer ``li`` with an explicit [B, NH, S, T]
    boolean mask (an int8 cache dequantized outside the timed region)."""
    import torch
    import torch.nn.functional as F

    from vggt_qwen3_tpu_torch.ops import decode_attention as da

    q = torch.randn(B, S, NH, D, device="cuda", generator=gen).bfloat16()
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    s0, end0 = da.verify_bounds(start, off, S, T)
    pos = torch.arange(T, device="cuda")
    q_end = end0[:, None] + torch.arange(S, device="cuda")[None, :]  # [B, S]
    hidden = ((pos[None] < s0[:, None]) | (pos[None] >= q_end[:, -1:]))[None, :, None, :]  # [1, B, 1, T]
    if quant:
        k = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, (L, B, NKV, T, D), device="cuda", generator=gen, dtype=torch.int8)
        ks = (torch.rand(L, B, NKV, T, device="cuda", generator=gen) * 0.02 + 0.005).bfloat16().masked_fill_(hidden, 1e4)
        vs = (torch.rand(L, B, NKV, T, device="cuda", generator=gen) * 0.02 + 0.005).bfloat16().masked_fill_(hidden, 1e4)
    else:
        k = torch.randn(L, B, NKV, T, D, device="cuda", generator=gen).bfloat16().masked_fill_(hidden[..., None], 1e4)
        v = torch.randn(L, B, NKV, T, D, device="cuda", generator=gen).bfloat16().masked_fill_(hidden[..., None], 1e4)
        ks = vs = None
    args = (q, k, v, li, start, off, ks, vs)
    got = da.gqa_block_verify_attention(*args)
    torch.cuda.synchronize()
    ref = da.gqa_block_verify_attention_plain(*args)
    empty = s0[:, None] >= q_end  # [B, S] queries with no valid slot
    if not empty.any() or got[empty].abs().max().item() != 0.0:
        raise AssertionError(f"block_verify_attention[{name}]: queries with no valid slot are not 0")
    agree = held_to_plain(f"block_verify_attention[{name}]", got[~empty], ref[~empty])
    del ref
    turn = layer_turns(L)
    kd, vd = (k, v) if not quant else ((k.float() * ks.float()[..., None]).bfloat16(),
                                       (v.float() * vs.float()[..., None]).bfloat16())
    mask = ((pos[None, None, :] >= s0[:, None, None]) & (pos[None, None, :] < q_end[:, :, None]))
    mask = mask[:, None].expand(B, NH, S, T)
    qt = q.transpose(1, 2)
    library_ms = device_ms(lambda: (lambda i: F.scaled_dot_product_attention(
        qt, kd[i], vd[i], attn_mask=mask, enable_gqa=True))(turn()), 2 * L)
    del kd, vd
    rotating = lambda: da.gqa_block_verify_attention(q, k, v, turn(), start, off, ks, vs)  # noqa: E731
    call_ms = cuda_ms(rotating, iters=2 * L)
    ms = device_ms(rotating, iters=2 * L)
    plain_ms = device_ms(lambda: da.gqa_block_verify_attention_plain(q, k, v, turn(), start, off, ks, vs), iters=6)
    # work this data needs: each row's slots [start, end0 + S − 1) read once;
    # each score row (query j, head) over its own [start, end0 + j)
    slots = (q_end[:, -1] - s0).clamp_min(0).sum().item()
    pairs = (q_end - s0[:, None]).clamp_min(0).sum().item() * NH
    itemsize = 1 if quant else 2
    nbytes = 2 * slots * NKV * D * itemsize + (2 * slots * NKV * 2 if quant else 0) + 2 * 2 * B * S * NH * D
    bms, by = bound_ms(nbytes, 4 * D * pairs)
    out = dict(shape=f"{name} q[{B},{S},{NH},{D}] cache[{L},{B},{NKV},{T},{D}] li turning over {L} layers",
               **agree, empty_queries=int(empty.sum()), ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bms, bound_by=by)
    print(f"block_verify_attention {json.dumps(out)}", flush=True)
    return out


def rand_w8(gen, *shape):
    """Random stacked W8 weight: int8 values, bf16 scales in [1e-3, 3e-3)."""
    import torch

    return {"w8": torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8),
            "scale": (torch.rand(*shape[:-2], 1, shape[-1], device="cuda", generator=gen) * 2e-3 + 1e-3
                      ).bfloat16()}


def w8_gemm_plan(M: int, K: int):
    """The kernel's own cut of a w8_gemm launch (rows, row groups, K parts,
    ring stages, shared memory bytes), or None for a build without
    ``w8_gemm_plan`` (a tree from before it)."""
    import ctypes

    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm

    lib = dm._lib()
    if not hasattr(lib, "w8_gemm_plan"):
        return None
    buf = (ctypes.c_int * 5)()
    if lib.w8_gemm_plan(M, K, ctypes.addressof(buf)) != 0:
        raise AssertionError(f"w8_gemm_plan({M}, {K}) refused")
    return list(buf)


def check_w8(cfg, M: int, gen, m_small: int = 8, *, head: bool = True) -> dict:
    """The four W8 decode kernels at the bench shape (``cfg`` = Qwen3-4B,
    M = 368 rows), each against its plain version, timed with the layer
    index turning over the layers; the yardstick is ``torch.mm`` over a bf16
    copy dequantized outside the timed region. QKV and WO also at
    ``m_small`` rows (the QA path's W8 decode step), the MLP's two launches
    (gate/up, then the down w8_gemm) timed apart by kernel name beside
    ``torch.mm`` for the down projection alone; two launches of each layer
    kernel on the same inputs must give the same bits. ``head``: also the
    head. Under "plans_and_bounds" (printed on a line of its own, never in
    a kernel's record): each w8_gemm launch's plan and the bounds other than
    each record's own ``bound_ms``."""
    import torch
    import torch.nn.functional as F

    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import quant

    L, H, NQ, NKV, Fd, V = (cfg.num_layers, cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size,
                            cfg.vocab_size)
    w = {"wq": rand_w8(gen, L, H, NQ), "wk": rand_w8(gen, L, H, NKV), "wv": rand_w8(gen, L, H, NKV),
         "wo": rand_w8(gen, L, NQ, H), "gate": rand_w8(gen, L, H, Fd), "up": rand_w8(gen, L, H, Fd),
         "down": rand_w8(gen, L, Fd, H)}
    head = {"w8": torch.randint(-127, 128, (V, H), device="cuda", generator=gen, dtype=torch.int8),
            "scale": (torch.rand(V, 1, device="cuda", generator=gen) * 2e-3 + 1e-3).bfloat16()}  # per vocab row
    x = torch.randn(M, H, device="cuda", generator=gen).bfloat16()
    a = torch.randn(M, NQ, device="cuda", generator=gen).bfloat16()
    act = (torch.randn(M, Fd, device="cuda", generator=gen) * 0.05).bfloat16()  # an MLP activation's scale
    xm = (x * 0.05).contiguous()  # the MLP's input: outputs of the order of one
    li = L - 1
    turn = layer_turns(L)
    out = {}

    def measure(name, rows, kernel, plain, library, flops, nbytes, compare):
        got, ref = kernel(li), plain(li)
        again = kernel(li)
        torch.cuda.synchronize()
        agree = compare(got, ref)
        if not all(torch.equal(g, h) for g, h in zip(got, again)):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        res = dict(**agree, ms=device_ms(lambda: kernel(turn()), iters=2 * L),
                   call_ms=cuda_ms(lambda: kernel(turn()), iters=2 * L),
                   host_ms=host_ms(lambda: kernel(turn()), iters=2 * L),
                   plain_ms=device_ms(lambda: plain(turn()), iters=4),
                   library_ms=device_ms(lambda: library(turn()), iters=2 * L))
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
        res["shape"] = f"M={rows} " + name
        print(f"{name.split()[0]} {json.dumps(res)}", flush=True)
        return res

    def held(name):
        return lambda got, ref: held_to_plain(name, torch.cat([g.flatten() for g in got]),
                                              torch.cat([r.flatten() for r in ref]))

    plans, bounds = {}, {}

    def with_small(name, res, small, K):
        """QKV/WO's measured figures at m_small rows beside the bench
        shape's; their plans and the small shape's bound go aside."""
        res.update({f"m{m_small}_{k}": small[k] for k in ("max_abs_err", "rel_rms", "ms", "call_ms", "host_ms",
                                                          "plain_ms", "library_ms")})
        bounds[f"{name}_m{m_small}"] = (small["bound_ms"], small["bound_by"])
        plans[name], plans[f"{name}_m{m_small}"] = w8_gemm_plan(M, K), w8_gemm_plan(m_small, K)
        return res

    w_qkv = torch.cat([quant.dequantize(w[k]) for k in ("wq", "wk", "wv")], dim=-1)
    for rows, xr in ((M, x), (m_small, x[:m_small].contiguous())):
        out[("qkv", rows)] = measure(
            f"fused_qkv_w8 x[{rows},{H}] wq|wk|wv[{L},{H},{NQ}+{NKV}+{NKV}]", rows,
            lambda i, xr=xr: dm.fused_qkv_w8(xr, w["wq"], w["wk"], w["wv"], i),
            lambda i, xr=xr: dm.fused_qkv_w8_plain(xr, w["wq"], w["wk"], w["wv"], i),
            lambda i, xr=xr: torch.mm(xr, w_qkv[i]),
            2 * rows * H * (NQ + 2 * NKV),
            H * (NQ + 2 * NKV) + 2 * (NQ + 2 * NKV) + 2 * rows * H + 2 * rows * (NQ + 2 * NKV),
            held("fused_qkv_w8"))
    out["fused_qkv_w8"] = with_small("qkv", out.pop(("qkv", M)), out.pop(("qkv", m_small)), H)
    del w_qkv
    w_o = quant.dequantize(w["wo"])
    for rows, ar in ((M, a), (m_small, a[:m_small].contiguous())):
        out[("wo", rows)] = measure(
            f"fused_linear_w8 a[{rows},{NQ}] wo[{L},{NQ},{H}]", rows,
            lambda i, ar=ar: (dm.fused_linear_w8(ar, w["wo"], i),),
            lambda i, ar=ar: (dm.fused_linear_w8_plain(ar, w["wo"], i),),
            lambda i, ar=ar: torch.mm(ar, w_o[i]),
            2 * rows * NQ * H, NQ * H + 2 * H + 2 * rows * NQ + 2 * rows * H, held("fused_linear_w8"))
    out["fused_linear_w8"] = with_small("wo", out.pop(("wo", M)), out.pop(("wo", m_small)), NQ)
    del w_o
    w_gu = torch.cat([quant.dequantize(w["gate"]), quant.dequantize(w["up"])], dim=-1)
    w_d = quant.dequantize(w["down"])

    def mlp_library(i):
        gu = torch.mm(xm, w_gu[i])
        return torch.mm(F.silu(gu[:, :Fd]) * gu[:, Fd:], w_d[i])

    def mlp(i):
        return (dm.fused_mlp_w8(xm, w["gate"], w["up"], w["down"], i),)

    res = measure(
        f"fused_mlp_w8 x[{M},{H}] gate/up[{L},{H},{Fd}] down[{L},{Fd},{H}]", M, mlp,
        lambda i: (dm.fused_mlp_w8_plain(xm, w["gate"], w["up"], w["down"], i),),
        mlp_library, 6 * M * H * Fd, 3 * H * Fd + 2 * (2 * Fd + H) + 2 * M * H + 2 * M * H, held("fused_mlp_w8"))
    # its two launches apart: gate/up (w8_swiglu) and the down projection (w8_gemm)
    by = device_ms_by_kernel(lambda: mlp(turn()), iters=2 * L)
    down_ms = sum(t for n, t in by.items() if "w8_gemm_kernel" in n)
    swiglu_ms = sum(t for n, t in by.items() if "w8_swiglu_kernel" in n)
    if down_ms <= 0 or swiglu_ms <= 0 or abs(down_ms + swiglu_ms - sum(by.values())) > 1e-9:
        raise AssertionError(f"fused_mlp_w8's kernels by name: {by}")
    res.update(swiglu_ms=swiglu_ms, down_ms=down_ms,
               down_library_ms=device_ms(lambda: torch.mm(act, w_d[turn()]), iters=2 * L))
    plans["down"] = w8_gemm_plan(M, Fd)
    bounds["swiglu"] = bound_ms(2 * H * Fd + 4 * Fd + 2 * M * H + 2 * M * Fd, 4 * M * H * Fd)
    bounds["down"] = bound_ms(Fd * H + 2 * H + 2 * M * Fd + 2 * M * H, 2 * M * Fd * H)
    down_got, down_ref = dm.fused_linear_w8(act, w["down"], li), dm.fused_linear_w8_plain(act, w["down"], li)
    res["down_rel_rms"] = held_to_plain("w8_gemm (down)", down_got, down_ref)["rel_rms"]
    print(f"fused_mlp_w8 by launch: {json.dumps({k: res[k] for k in res if k.startswith(('swiglu', 'down'))})}",
          flush=True)
    out["fused_mlp_w8"] = res
    # read from the kernel's configuration or computed, not measured: never in a record
    out["plans_and_bounds"] = dict(plans=plans, bounds_ms=bounds)
    print(f"w8_gemm plans [rows, row groups, K parts, ring stages, smem bytes] and bounds: "
          f"{json.dumps(out['plans_and_bounds'])}", flush=True)
    del w_gu, w_d, w
    if not head:
        torch.cuda.empty_cache()
        return out

    # the head: a table too large for L2 (389 MB), so it is cold on every launch anyway
    tok, mx = dm.fused_head_argmax(x, head)
    torch.cuda.synchronize()
    logits = dm.head_logits(x, head)
    ref_tok = torch.argmax(logits, -1)
    top2 = torch.topk(logits, 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-4 * logits.abs().amax()
    if decisive.float().mean().item() < 0.99 or not torch.equal(tok[decisive].long(), ref_tok[decisive]):
        raise AssertionError(f"fused_head_argmax: {int(decisive.sum())}/{M} decisive rows, tokens equal on "
                             f"{int((tok[decisive].long() == ref_tok[decisive]).sum())}")
    max_err = (mx[decisive] - top2[decisive, 0]).abs().max().item()
    del logits
    w_h = quant.dequantize(head)  # [V, H] bf16: the scale folded in before the dot, a yardstick only
    res = dict(decisive_rows=int(decisive.sum()), tokens_equal=int(decisive.sum()), max_abs_err=max_err,
               ms=device_ms(lambda: dm.fused_head_argmax(x, head), iters=10),
               call_ms=cuda_ms(lambda: dm.fused_head_argmax(x, head), iters=10),
               plain_ms=device_ms(lambda: dm.fused_head_argmax_plain(x, head), iters=2),
               library_ms=device_ms(lambda: torch.mm(x, w_h.t(), out_dtype=torch.float32).argmax(-1), iters=10))
    res["bound_ms"], res["bound_by"] = bound_ms(V * H + 2 * V + 2 * M * H + 8 * M, 2 * M * H * V)
    res["shape"] = f"M={M} fused_head_argmax x[{M},{H}] w8[{V},{H}]"
    print(f"fused_head_argmax {json.dumps(res)}", flush=True)
    out["fused_head_argmax"] = res
    del w_h, head
    torch.cuda.empty_cache()
    return out


def reference_check(seed: int):
    """A small-width bf16 model (head dims 64, so both kernels run) on the
    card against the same weights and inputs on the CPU: prefill and first
    decode-step logits, relative to the logits' scale."""
    import dataclasses

    import torch

    from vggt_qwen3_tpu_torch.config import PerceiverConfig, Qwen3Config, VGGTConfig
    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference.batching import encode_prompts, spliced_prompt, stack_views
    from vggt_qwen3_tpu_torch.models import qwen3, vlm

    full = full_stage()
    stage = dataclasses.replace(
        full,
        model=dataclasses.replace(
            full.model,
            text=Qwen3Config(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                             head_dim=64, intermediate_size=512),
            vision=VGGTConfig(img_size=112, embed_dim=128, num_layers=2, num_heads=2, patch_depth=2),
            projector=PerceiverConfig(latent_dim=128, num_latents=16, num_heads=4, num_layers=2, ffn_dim=256),
            num_vis_tokens=16,
        ),
        data=dataclasses.replace(full.data, image_size=112),
    )
    cpu_params = vlm.init_params(torch.Generator().manual_seed(seed), stage.model)
    tok = load_tokenizer(None)
    samples = load_samples(seed + 1)
    prompts = [f"{s['question']}\n<image>\n" for s in samples]

    def logits_on(dev, params):
        ids, mask = (torch.from_numpy(a).to(dev) for a in encode_prompts(tok, prompts, pad_to_len=0))
        images = stack_views(samples, stage.data.image_size, dev)
        with torch.inference_mode():
            emb, m2 = spliced_prompt(params, stage, tok.convert_tokens_to_ids("<image>"), images, ids, mask)
            B, S, _ = emb.shape
            cfg = stage.model.text
            cache = qwen3.init_cache(cfg, B, S + 1, device=dev)
            mask_full = torch.cat([m2.int(), torch.ones(B, 1, dtype=torch.int32, device=dev)], 1)
            pos = torch.clamp_min(torch.cumsum(m2.int(), -1) - 1, 0)
            l0, cache = qwen3.forward(params["text"], cfg, inputs_embeds=emb, attention_mask=mask_full,
                                      positions=pos, cache=cache, prefill_padding="left", last_logit_only=True)
            nxt = torch.argmax(l0[:, -1], -1)
            l1, _ = qwen3.forward(params["text"], cfg, input_ids=nxt[:, None], attention_mask=mask_full,
                                  positions=pos[:, -1:] + 1, cache=cache, cache_offset=S, decode_frontier=True)
        return l0.float().cpu(), l1.float().cpu(), nxt.cpu()

    ref0, ref1, ref_tok = logits_on(torch.device("cpu"), cpu_params)
    gpu_params = _to_device(cpu_params, "cuda")
    got0, got1, got_tok = logits_on(torch.device("cuda"), gpu_params)
    rel0 = ((got0 - ref0).abs().max() / ref0.abs().max()).item()
    # the decode step is fed the CPU's tokens' logits only where both chose the same token
    same = got_tok == ref_tok
    rel1 = ((got1[same] - ref1[same]).abs().max() / ref1[same].abs().max()).item() if same.any() else float("nan")
    print(f"reference check (small width, card vs CPU, bf16): prefill rel err {rel0:.4g}, "
          f"decode rel err {rel1:.4g}, same first token {int(same.sum())}/{len(same)}", flush=True)
    if not (np.isfinite(got0.numpy()).all() and np.isfinite(got1.numpy()).all()):
        raise AssertionError("reference check: non-finite logits on the card")
    if not rel0 < 0.05 or not (rel1 < 0.05 or not same.any()):
        raise AssertionError(f"reference check: card and CPU disagree (prefill {rel0}, decode {rel1})")


def reference_check_w8(seed: int):
    """A small-width W8 model (tied int8 head, int8 cache) on the card
    against the same weights and inputs on the CPU: prefill logits, the
    first decode step's logits (the three W8 layer kernels) and its greedy
    tokens (the head-argmax kernel) on decisive rows."""
    import torch

    from vggt_qwen3_tpu_torch.config import Qwen3Config
    from vggt_qwen3_tpu_torch.models import qwen3

    cfg = Qwen3Config(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      intermediate_size=512)
    cpu_params = qwen3.quantize_params(qwen3.init_params(torch.Generator().manual_seed(seed), cfg))
    B, S = 16, 12
    ids = torch.from_numpy(np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S)))
    mask = torch.ones(B, S + 1, dtype=torch.int32)

    def run(dev, params):
        with torch.inference_mode():
            cache = qwen3.init_cache(cfg, B, S + 1, dtype="int8", device=dev)
            l0, cache = qwen3.forward(params, cfg, input_ids=ids.to(dev), attention_mask=mask.to(dev),
                                      cache=cache, prefill_padding="left", last_logit_only=True)
            nxt = torch.argmax(l0[:, -1].cpu(), -1)  # the CPU's choice feeds both
            return l0.float().cpu(), nxt, cache

    ref0, nxt, ref_cache = run(torch.device("cpu"), cpu_params)
    gpu_params = _to_device(cpu_params, "cuda")
    got0, _, got_cache = run(torch.device("cuda"), gpu_params)

    def step(dev, params, cache):
        with torch.inference_mode():
            kw = dict(input_ids=nxt[:, None].to(dev), attention_mask=mask.to(dev),
                      positions=torch.full((B, 1), S, device=dev), cache_offset=S, decode_frontier=True)
            l1, _ = qwen3.forward(params, cfg, cache={k: t.clone() for k, t in cache.items()}, **kw)
            tok, _ = qwen3.forward_greedy(params, cfg, cache=cache, **kw)
        return l1.float().cpu()[:, 0], tok.cpu()

    ref1, ref_tok = step(torch.device("cpu"), cpu_params, ref_cache)
    got1, got_tok = step(torch.device("cuda"), gpu_params, got_cache)
    rel0 = ((got0 - ref0).abs().max() / ref0.abs().max()).item()
    rel1 = ((got1 - ref1).abs().max() / ref1.abs().max()).item()
    top2 = torch.topk(ref1, 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 0.02 * ref1.abs().max()  # above the bf16 noise of the two runs
    same = int((got_tok[decisive] == ref_tok[decisive]).sum())
    print(f"reference check (small width, W8 + int8 cache, card vs CPU): prefill rel err {rel0:.4g}, "
          f"decode step rel err {rel1:.4g}, greedy tokens equal on {same}/{int(decisive.sum())} decisive rows "
          f"({B} rows)", flush=True)
    if not (np.isfinite(got0.numpy()).all() and np.isfinite(got1.numpy()).all()):
        raise AssertionError("W8 reference check: non-finite logits on the card")
    if not (rel0 < 0.05 and rel1 < 0.05 and same == int(decisive.sum()) and decisive.any()):
        raise AssertionError(f"W8 reference check: card and CPU disagree (prefill {rel0}, decode {rel1}, "
                             f"tokens {same}/{int(decisive.sum())})")


def constrained_gaps(engine, run):
    """Run ``run()`` with the engine's selection recorded: per step, the top-2
    gap of the logits greedy takes its argmax over (grammar-masked
    processors, or the raw fallback), relative to the row's max|raw logit|.
    Returns (run's result, [steps, B] gaps on the host)."""
    import torch

    gaps = []
    real = engine.constrained_candidates

    def recording(raw, processed, fsm_state, constraint):
        cand = real(raw, processed, fsm_state, constraint)
        top = torch.topk(cand, 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]) / raw.abs().amax(-1))
        return cand

    engine.constrained_candidates = recording
    try:
        res = run()
    finally:
        engine.constrained_candidates = real
    return res, torch.stack(gaps).cpu().numpy()


def reference_check_speculative(seed: int):
    """A small-width bf16 model (head dim 64, so the kernels run) decodes
    speculatively under the action-JSON constraint with an int8 cache, on
    the card and on the CPU. Every row whose every step is decisive (the
    CPU's top-2 gap above 1e-4·max|logit|) must give the same tokens, and
    there must be such a row."""
    import torch

    from vggt_qwen3_tpu_torch.config import Qwen3Config
    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference import engine, speculative
    from vggt_qwen3_tpu_torch.inference.constrained import action_json_constraint
    from vggt_qwen3_tpu_torch.models import qwen3
    from vggt_qwen3_tpu_torch.ops import decode_attention as da

    cfg = Qwen3Config(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      intermediate_size=512)
    cpu_params = qwen3.init_params(torch.Generator().manual_seed(seed), cfg)
    tok = load_tokenizer(None)
    table = torch.from_numpy(action_json_constraint(tok, vocab_size=cfg.vocab_size))
    B, S, N = 8, 24, 48
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(1, 256, (B, S)).astype(np.int32))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[0, :5] = 0
    gcfg = engine.GenerationConfig(max_new_tokens=N, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                                   repetition_penalty=1.1, no_repeat_ngram=4, kv_dtype="int8")

    def run(dev, params, spec=True):
        with torch.inference_mode():
            kw = dict(inputs_embeds=qwen3.embed_tokens(params, ids.to(dev)), attention_mask=mask.to(dev),
                      constraint=table.to(dev))
            if spec:
                return speculative.generate_speculative(params, cfg, gcfg, prompt_ids=ids.to(dev), draft_k=DRAFT_K,
                                                        ngram=3, **kw)
            return engine.generate(params, cfg, gcfg, **kw)

    ref_t, ref_l, ref_it = run(torch.device("cpu"), cpu_params)
    (plain_t, _), gaps = constrained_gaps(engine, lambda: run(torch.device("cpu"), cpu_params, spec=False))
    if not np.array_equal(plain_t, ref_t):
        raise AssertionError("speculative reference check: on the CPU speculative and plain tokens differ")
    gpu_params = _to_device(cpu_params, "cuda")
    da.verify_launches = 0
    got_t, got_l, got_it = run(torch.device("cuda"), gpu_params)
    torch.cuda.synchronize()
    if da.verify_launches != cfg.num_layers * got_it or got_it < 1:
        raise AssertionError(f"speculative reference check: {da.verify_launches} verify launches, {got_it} iterations")
    live = np.arange(N)[:, None] < ref_l[None, :]  # [N, B] steps each row emitted
    decisive_4 = np.where(live, gaps[:N], np.inf).min(0) > 1e-4
    equal = (got_t == ref_t).all(-1) & (got_l == ref_l)
    first = [int(np.nonzero(got_t[b] != ref_t[b])[0][0]) if not (got_t[b] == ref_t[b]).all() else None
             for b in range(B)]
    print(f"reference check (small width, speculative, action-JSON constraint, int8 cache, card vs CPU): "
          f"{int(equal.sum())}/{B} rows token-identical; rows decisive at 1e-4: {int(decisive_4.sum())} "
          f"(identical {int((equal & decisive_4).sum())}); first differing step and CPU gap there: "
          f"{[(b, t, float(gaps[t, b])) for b, t in enumerate(first) if t is not None]}; "
          f"iterations card {got_it}, CPU {ref_it}", flush=True)
    if not decisive_4.any() or not equal[decisive_4].all():
        raise AssertionError("speculative reference check: card and CPU differ on a decisive row, or none is")


def _fingerprint(t):
    """An exact fingerprint of a tensor's bits: (sum, sum of squares) of its
    16-bit words as int64 — any update of an element changes it."""
    import torch

    w = t.detach().contiguous().view(torch.int16).to(torch.int64)
    return int(w.sum()), int((w * w).sum())


def _small_train_stage():
    """A small-width stage for the card-vs-CPU training check: VGGT head dim
    64, so the flash kernels run on the card; LoRA on qkvo with layer 0
    frozen; the tower unfrozen; Perceiver dropout off (the two devices' random
    streams differ)."""
    import dataclasses

    from vggt_qwen3_tpu_torch.config import PerceiverConfig, Qwen3Config, VGGTConfig

    st = train_stage()
    return dataclasses.replace(
        st,
        model=dataclasses.replace(
            st.model,
            text=Qwen3Config(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                             head_dim=64, intermediate_size=512),
            vision=VGGTConfig(img_size=112, embed_dim=128, num_layers=2, num_heads=2, patch_depth=2),
            projector=PerceiverConfig(latent_dim=128, num_latents=16, num_heads=4, num_layers=2, ffn_dim=256,
                                      dropout=0.0),
            num_vis_tokens=16, geom_tokens=2, freeze_vision=False),
        data=dataclasses.replace(st.data, image_size=112, num_views=2, max_length=96),
        train=dataclasses.replace(st.train, lr=1e-4, proj_lr=1e-3),
        lora=dataclasses.replace(st.lora, rank=4), freeze_text_layers=(0,),
    )


def reference_check_train(seed: int):
    """The training step at small width, bf16, the tower unfrozen: the card
    (kernels 1, 8, 9) against the CPU (their plain versions), from the same
    weights and batches, 4 micro steps (2 updates at grad_accum 2: the first
    runs at the warmup's learning rate 0, the second at the peak). Compared:
    loss (rel 1e-2) and grad_norm (rel 2e-2) at every micro step; each vision
    leaf's first-micro-step gradient (‖Δ‖₂ ≤ 0.05·‖ref‖₂); the parameter
    updates after the 2 updates (‖Δcard − Δcpu‖₂ ≤ 0.1·‖Δcpu‖₂ over the
    trainable leaves, no element more than three learning-rate steps apart);
    frozen leaves bit-identical. The tolerances are bf16's: both sides round every
    intermediate to bf16 in their own summation orders through 6 blocks and
    back. Then the card's state is saved and restored: the restored optimizer
    state equals the saved one bit for bit, and the next two micro steps give
    the live run's losses exactly and its update to 1e-3."""
    import shutil

    import torch

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa
    from vggt_qwen3_tpu_torch.train import checkpoint as ckpt
    from vggt_qwen3_tpu_torch.train import sft, trainer

    st = _small_train_stage()
    tok = load_tokenizer(None)
    img_id = tok.convert_tokens_to_ids("<image>")
    loader = sft.build_data(st, tok, datasets=seeded_datasets(st, seed))
    batches = [next(loader) for _ in range(6)]
    cpu, cpu_tx = trainer.init_train_state(torch.Generator().manual_seed(seed), st, dtype="bfloat16")
    card_params = _to_device(cpu.params, "cuda")
    card_tx = trainer.make_tx(st, card_params)
    card = trainer.TrainState(params=card_params, opt_state=card_tx.init(card_params), step=0)
    init = {n: t.clone() for n, t in trainer.named_leaves(cpu.params)}

    def run(state, tx, dev, steps):
        grads, metrics = {}, []
        real = tx.update

        def capture(g, opt_state, params):
            if not grads:
                grads.update({n: t.float().cpu() for n, t in g.items() if n.startswith("vision/") and t is not None})
            return real(g, opt_state, params)

        tx.update = capture
        try:
            step = trainer.make_train_step(st, tx, img_id, has_geom=True)
            for s in steps:
                state, m = step(state, sft.to_device(batches[s], dev), None)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        finally:
            tx.update = real
        return state, grads, metrics

    n0 = (fa.launches, fa.dq_launches, fa.dkv_launches)
    card, card_g, card_m = run(card, card_tx, "cuda", range(4))
    torch.cuda.synchronize()
    card_launches = (fa.launches - n0[0], fa.dq_launches - n0[1], fa.dkv_launches - n0[2])
    cpu, cpu_g, cpu_m = run(cpu, cpu_tx, "cpu", range(4))
    vc = st.model.vision
    blocks = vc.patch_depth + 2 * vc.num_layers
    if card_launches != (4 * 2 * blocks, 4 * blocks, 4 * blocks):
        raise AssertionError(f"training reference check: launches (fwd, dq, dkv) {card_launches}")
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card_m, cpu_m))
    norm_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(card_m, cpu_m))
    grad_rel = {n: ((card_g[n] - cpu_g[n]).norm() / cpu_g[n].norm().clamp_min(1e-30)).item() for n in cpu_g}
    if set(card_g) != set(cpu_g) or len(cpu_g) == 0:
        raise AssertionError("training reference check: vision gradients missing on a side")
    num = den = 0.0
    worst_steps = 0.0
    lr = {"base": st.train.lr, "proj": st.train.proj_lr}
    cpu_leaves = dict(trainer.named_leaves(cpu.params))
    for n, p in trainer.named_leaves(card.params):
        label = card_tx.labels[n]
        got, ref, p0 = p.float().cpu(), cpu_leaves[n].float(), init[n].float()
        if label == "frozen" or (n.startswith("text/layers/lora/")):
            frozen_part = (got if label == "frozen" else got[0]) - (p0 if label == "frozen" else p0[0])
            if frozen_part.abs().max().item() != 0.0:
                raise AssertionError(f"training reference check: frozen leaf {n} changed on the card")
        if label == "frozen":
            continue
        num += ((got - p0) - (ref - p0)).norm().item() ** 2
        den += (ref - p0).norm().item() ** 2
        worst_steps = max(worst_steps, (got - ref).abs().max().item() / lr[label])
    upd_rel = (num / max(den, 1e-30)) ** 0.5
    worst_grad = max(grad_rel.items(), key=lambda kv: kv[1])
    print(f"training reference check (small width, bf16, tower unfrozen, card vs CPU): loss rel {loss_rel:.3e}, "
          f"grad_norm rel {norm_rel:.3e}, vision gradients worst rel {worst_grad[1]:.3e} ({worst_grad[0]}, "
          f"{len(grad_rel)} leaves), updates rel {upd_rel:.3e}, largest element gap {worst_steps:.3f} steps; "
          f"card launches (fwd, dq, dkv) {card_launches}; losses card {[round(m[0], 5) for m in card_m]} "
          f"CPU {[round(m[0], 5) for m in cpu_m]}", flush=True)
    if not (loss_rel <= 1e-2 and norm_rel <= 2e-2 and worst_grad[1] <= 5e-2 and upd_rel <= 0.1
            and worst_steps <= 2.0 * 1.5):
        raise AssertionError("training reference check: card and CPU disagree")

    # save, restore, and the same next two micro steps
    out = REPO / "ckpts" / "chip_smoke_train"
    shutil.rmtree(out, ignore_errors=True)
    try:
        ckpt.save(card, out / "step_4")
        restored = ckpt.restore(ckpt.latest_step_dir(out), "cuda")
        for key in ("mu", "nu", "acc"):
            a, b = card.opt_state[key], restored.opt_state[key]
            if a.keys() != b.keys() or not all(torch.equal(a[n], b[n]) for n in a):
                raise AssertionError(f"restore: optimizer state {key} differs")
        if (restored.step, restored.opt_state["gradient_step"], restored.opt_state["mini_step"]) != \
                (card.step, card.opt_state["gradient_step"], card.opt_state["mini_step"]):
            raise AssertionError("restore: counters differ")
        before = {n: t.float().clone() for n, t in trainer.named_leaves(card.params)}
        live, _, live_m = run(card, card_tx, "cuda", range(4, 6))
        again, _, again_m = run(restored, trainer.make_tx(st, restored.params), "cuda", range(4, 6))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    num = den = 0.0
    for (n, a), (_, b) in zip(trainer.named_leaves(live.params), trainer.named_leaves(again.params)):
        num += (a.float() - b.float()).norm().item() ** 2
        den += (a.float() - before[n]).norm().item() ** 2
    rel = (num / max(den, 1e-30)) ** 0.5
    print(f"training restore check: next losses live {live_m} restored {again_m}; updates rel {rel:.3e}", flush=True)
    if [m[0] for m in live_m] != [m[0] for m in again_m] or not rel <= 1e-3 or den == 0.0:
        raise AssertionError("restore: the restored state does not give the live run's next steps")


def train_path(args):
    """The full-width SFT path on the card: the stage of configs/stage1_3d.yaml
    (train_stage) through the trainer's entry points (init_train_state,
    sft.build_data over the ScanQA/SQA3D placeholder records with seeded
    views, make_train_step, step_generator): (a) the recipe as shipped, the
    tower frozen, 2 micro steps; (b) freeze_vision false, 4 micro steps (2
    updates). Launch counters are set to 0 just before and read just after
    each micro step and each run. Returns (b)'s per-run counts and numbers."""
    import dataclasses
    import gc

    import torch

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa
    from vggt_qwen3_tpu_torch.train import sft, trainer

    tok = load_tokenizer(None)
    img_id = tok.convert_tokens_to_ids("<image>")
    base = train_stage()
    vc = base.model.vision
    blocks = vc.patch_depth + 2 * vc.num_layers  # 72 attentions a forward
    result = {}
    for frozen, n_micro in ((True, 2), (False, 2 * TRAIN_GRAD_ACCUM)):
        st = dataclasses.replace(base, model=dataclasses.replace(base.model, freeze_vision=frozen))
        what = "recipe as shipped (tower frozen)" if frozen else "freeze_vision false"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, tx = trainer.init_train_state(torch.Generator(device="cuda").manual_seed(args.seed), st,
                                             dtype=st.model.dtype)
        torch.cuda.synchronize()
        leaves = dict(trainer.named_leaves(state.params))
        n_params = sum(p.numel() for p in leaves.values())
        n_train = sum(p.numel() for n, p in leaves.items() if tx.labels[n] != "frozen")
        print(f"training ({what}): random init of {n_params / 1e9:.3f} B params ({n_train / 1e9:.3f} B trainable) "
              f"in {time.perf_counter() - t:.1f} s, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        prints = {n: _fingerprint(p) for n, p in leaves.items()}
        lora_frozen = {n: [_fingerprint(p[i]) for i in st.freeze_text_layers]
                       for n, p in leaves.items() if n.startswith("text/layers/lora/")}
        min_abs = {n: p.abs().min().item() for n, p in leaves.items() if tx.labels[n] != "frozen"}
        loader = sft.build_data(st, tok, datasets=seeded_datasets(st, args.seed))
        step_fn = trainer.make_train_step(st, tx, img_id, has_geom=True)
        walls, per_step, metrics, tokens = [], [], [], []
        run_counts = dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0)
        for s in range(n_micro):
            batch = sft.to_device(next(loader), "cuda")
            gen = trainer.step_generator(st.train.seed + 1, s, "cuda")
            torch.cuda.synchronize()
            fa.launches = fa.dq_launches = fa.dkv_launches = 0
            t = time.perf_counter()
            state, m = step_fn(state, batch, gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
            per_step.append(counts)
            for k, c in zip(run_counts, counts):
                run_counts[k] += c
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            tokens.append((int(batch["input_ids"].numel()), int(batch["attention_mask"].sum())))
        want = (blocks, 0, 0) if frozen else (2 * blocks, blocks, blocks)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = walls[1:] or walls
        mean = sum(steady) / len(steady)
        print(f"training ({what}): {n_micro} micro steps of {TRAIN_BATCH} rows x {st.data.num_views} views "
              f"x {st.data.image_size}^2, text {tokens[0][0] // TRAIN_BATCH} tokens a row; walls "
              f"{[round(w, 3) for w in walls]} s; launches a micro step (flash fwd, dq, dkv) {per_step}; "
              f"loss/grad_norm {metrics}; peak memory {peak:.2f} GiB", flush=True)
        if any(c != want for c in per_step):
            raise AssertionError(f"training ({what}): launches a micro step {per_step}, expected {want}")
        if not all(np.isfinite(x) for m in metrics for x in m):
            raise AssertionError(f"training ({what}): loss or grad_norm not finite: {metrics}")
        if state.opt_state["gradient_step"] != n_micro // TRAIN_GRAD_ACCUM:
            raise AssertionError(f"training ({what}): {state.opt_state['gradient_step']} updates")
        leaves = dict(trainer.named_leaves(state.params))
        for n, p in leaves.items():
            if tx.labels[n] == "frozen" and _fingerprint(p) != prints[n]:
                raise AssertionError(f"training ({what}): frozen leaf {n} changed")
        for n, fps in lora_frozen.items():
            if [_fingerprint(leaves[n][i]) for i in st.freeze_text_layers] != fps:
                raise AssertionError(f"training ({what}): the adapters of a frozen layer changed ({n})")
        if not frozen:
            # a trainable leaf may stay unchanged only where its update is under half a bf16
            # ulp everywhere: no gradient reached it (LoRA's A while B is still 0: its step
            # is the weight decay alone), or no element is small enough for a step of the
            # group's size (|p| > 768·lr puts 1.5·lr under half an ulp: norm weights, LayerScale)
            lr = {"base": st.train.lr, "proj": st.train.proj_lr}
            moved = [n for n, p in leaves.items() if tx.labels[n] != "frozen" and _fingerprint(p) != prints[n]]
            still = [n for n in min_abs if n not in moved]
            no_grad = [n for n in still if not state.opt_state["mu"][n].any()]
            bad = [n for n in still if n not in no_grad and min_abs[n] <= 768 * lr[tx.labels[n]]]
            print(f"training ({what}): {len(moved)} of {len(min_abs)} trainable leaves changed; unchanged with no "
                  f"gradient yet: {no_grad}; unchanged, every element's step under half a bf16 ulp: "
                  f"{[n for n in still if n not in no_grad]}", flush=True)
            if bad:
                raise AssertionError(f"training ({what}): trainable leaves unchanged after the updates: {bad}")
            result.update(counts=run_counts, per_step=per_step[0], walls=walls, mean_s=mean, peak_gib=peak,
                          tokens_per_s=TRAIN_BATCH * (tokens[0][0] // TRAIN_BATCH) / mean,
                          valid_tokens_per_s=sum(v for _, v in tokens[1:] or tokens) / sum(steady),
                          views_per_s=TRAIN_BATCH * st.data.num_views / mean)
            print(f"training ({what}): micro step {mean:.3f} s (mean of the synchronised walls after the first), "
                  f"{result['tokens_per_s']:.1f} text tokens/s padded, {result['valid_tokens_per_s']:.1f} unpadded, "
                  f"{result['views_per_s']:.2f} views/s; launches in the run {json.dumps(run_counts)}", flush=True)
            # one more update's pair of micro steps: the second, which runs the optimizer, under the profiler
            state, _ = step_fn(state, sft.to_device(next(loader), "cuda"),
                               trainer.step_generator(st.train.seed + 1, n_micro, "cuda"))
            batch = sft.to_device(next(loader), "cuda")
            gen = trainer.step_generator(st.train.seed + 1, n_micro + 1, "cuda")
            profile_breakdown("training micro step (freeze_vision false, with the update)",
                              lambda: step_fn(state, batch, gen), unprofiled_s=mean, range_family="optimizer")
        del state, tx, leaves, loader, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return result


def main_path(args):
    """Full-width QA path through run_inference, bf16 then int8 cache."""
    import torch

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference import batching, engine, qa
    from vggt_qwen3_tpu_torch.models import qwen3
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    stage = full_stage()
    t0 = time.perf_counter()
    params = qa.load_model(stage, rng_seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"main path: random init of {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s", flush=True)
    tok = load_tokenizer(None)  # random weights: the byte tokenizer, no files needed
    samples = load_samples(args.seed)

    captured = []
    real_generate_batch = qa.generate_batch

    def recording_generate_batch(*a, **kw):
        tokens, lengths = real_generate_batch(*a, **kw)
        captured.append((tokens.copy(), lengths.copy()))
        return tokens, lengths

    qa.generate_batch = recording_generate_batch
    runs, walls = {}, {}
    try:
        for kv in (None, "int8"):
            outs = []
            for rep in range(2):
                captured.clear()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                fa.launches = 0
                da.launches = 0
                t = time.perf_counter()
                res = qa.run_inference(params, stage, tok, samples, max_new_tokens=args.max_new_tokens,
                                       batch_size=8, kv_dtype=kv, verbose=False, device="cuda")
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                walls[kv] = secs  # the repeat run's wall time is kept
                counts = (fa.launches, da.launches)
                outs.append((res, [c[0] for c in captured], counts))
                steps = counts[1] // stage.model.text.num_layers
                print(f"main path kv={kv or 'bf16'} run {rep}: {secs:.3f} s, decode steps {steps}, "
                      f"flash launches {counts[0]}, decode launches {counts[1]}, "
                      f"max memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
            (res_a, tok_a, cnt_a), (res_b, tok_b, cnt_b) = outs
            if res_a != res_b or any(not np.array_equal(x, y) for x, y in zip(tok_a, tok_b)):
                raise AssertionError(f"kv={kv}: a repeat run gave other tokens")
            vc = stage.model.vision
            want_flash = vc.patch_depth + 2 * vc.num_layers + stage.model.text.num_layers
            if cnt_a[0] != want_flash or cnt_a[1] < stage.model.text.num_layers \
                    or cnt_a[1] % stage.model.text.num_layers:
                raise AssertionError(f"kv={kv}: launch counts {cnt_a}, expected {want_flash} flash "
                                     f"and a positive multiple of {stage.model.text.num_layers} decode")
            runs[kv] = cnt_a
        # the same path once with W8 text weights and the int8 cache
        dm.launches.update(dict.fromkeys(dm.launches, 0))
        da.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res_w8 = qa.run_inference(params, stage, tok, samples, max_new_tokens=args.max_new_tokens, batch_size=8,
                                  kv_dtype="int8", quantize=True, verbose=False, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        steps = da.launches // stage.model.text.num_layers
        print(f"main path W8 (quantize=True) kv=int8: {secs:.3f} s incl. quantizing, decode steps {steps}, "
              f"W8 launches {dm.launches}", flush=True)
        L = stage.model.text.num_layers
        if len(res_w8) != len(samples) or any(dm.launches[k] != L * steps for k in
                                              ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8")):
            raise AssertionError(f"W8 QA run: {len(res_w8)} records, launches {dm.launches}, {steps} steps")
        # a trained stage-1 tree carries qkvo LoRA adapters: served W8, only the MLP has no adapter to keep
        # its fused kernel from running (QKV and WO dequantize and multiply, as in the JAX module)
        lora_text = qwen3.add_lora(params["text"], stage.model.text, train_stage().lora,
                                   torch.Generator(device="cuda").manual_seed(1))
        dm.launches.update(dict.fromkeys(dm.launches, 0))
        da.launches = 0
        res_lora = qa.run_inference(dict(params, text=lora_text), stage, tok, samples,
                                    max_new_tokens=args.max_new_tokens, batch_size=8, kv_dtype="int8",
                                    quantize=True, verbose=False, device="cuda")
        steps = da.launches // L
        want = {"fused_qkv_w8": 0, "fused_linear_w8": 0, "fused_mlp_w8": L * steps}
        print(f"main path W8 with qkvo LoRA: decode steps {steps}, W8 launches {dm.launches}", flush=True)
        if len(res_lora) != len(samples) or not steps or any(dm.launches[k] != n for k, n in want.items()):
            raise AssertionError(f"W8 QA run with LoRA: {len(res_lora)} records, launches {dm.launches}, "
                                 f"expected {want}")
        del lora_text
    finally:
        qa.generate_batch = real_generate_batch

    # the path's outputs: finite vision features and logits of the right shape
    prompts = [f"{s['question']}\n<image>\n" for s in samples]
    pad_to = batching.max_prompt_len(tok, prompts)
    ids, mask = (torch.from_numpy(a).cuda() for a in batching.encode_prompts(tok, prompts, pad_to_len=pad_to))
    images = batching.stack_views(samples, stage.data.image_size, "cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    emb, m2 = batching.spliced_prompt(params, stage, tok.convert_tokens_to_ids("<image>"), images, ids, mask)
    torch.cuda.synchronize()
    t_vision = time.perf_counter() - t
    with torch.inference_mode():
        B, S, _ = emb.shape
        cache = qwen3.init_cache(stage.model.text, B, S, device="cuda")
        pos = torch.clamp_min(torch.cumsum(m2.int(), -1) - 1, 0)
        t = time.perf_counter()
        logits, _ = qwen3.forward(params["text"], stage.model.text, inputs_embeds=emb, attention_mask=m2,
                                  positions=pos, cache=cache, prefill_padding="left", last_logit_only=True)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t
    if tuple(logits.shape) != (8, 1, stage.model.text.vocab_size) or not torch.isfinite(logits).all() \
            or not torch.isfinite(emb.float()).all():
        raise AssertionError(f"main path: logits {tuple(logits.shape)} not finite or of the wrong shape")
    gen_cfg = engine.GenerationConfig(max_new_tokens=args.max_new_tokens, eos_token_id=tok.eos_token_id,
                                      pad_token_id=tok.pad_token_id, repetition_penalty=1.1)

    def generate():
        return engine.generate_early_exit(params["text"], stage.model.text, gen_cfg,
                                          inputs_embeds=emb, attention_mask=m2)

    t = time.perf_counter()
    _, _, steps = generate()
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    print(f"main path: prefill [8, {S}] logits finite, shape {tuple(logits.shape)}; "
          f"host-timed phases: vision+splice {t_vision:.3f} s, prefill {t_prefill:.3f} s, "
          f"generate (prefill + {steps} decode steps) {t_gen:.3f} s, "
          f"{(t_gen - t_prefill) / max(steps, 1) * 1e3:.2f} ms a decode step", flush=True)
    profile_breakdown("QA batch", lambda: qa.run_inference(
        params, stage, tok, samples, max_new_tokens=args.max_new_tokens, batch_size=8, verbose=False,
        device="cuda"), unprofiled_s=walls[None])
    profile_breakdown("generate", generate, unprofiled_s=t_gen)
    del params
    torch.cuda.empty_cache()
    return runs


def w8_bench_path(args):
    """The W8 decode path at full width through the port's bench: Qwen3-4B,
    W8 weights, int8 cache, B=368, prompt 32, 128 greedy steps. The launch
    counters are set to 0 just before the first timed ``generate`` and read
    just after it; the second timed run must give the same tokens."""
    import contextlib

    import torch

    from vggt_qwen3_tpu_torch import bench
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    bargs = bench.parse_args(["--seed", str(args.seed)])
    counts = {}

    @contextlib.contextmanager
    def count(i):
        if i == 0:
            dm.launches.update(dict.fromkeys(dm.launches, 0))
            fa.launches = da.launches = 0
        yield
        if i == 0:
            torch.cuda.synchronize()
            counts.update(dm.launches, flash_fwd=fa.launches, decode_attention=da.launches)

    t = time.perf_counter()
    s = bench.setup(bargs)
    torch.cuda.synchronize()
    print(f"W8 bench: random init + quantize in {time.perf_counter() - t:.1f} s", flush=True)
    res = bench.run(bargs, around_rep=count, s=s)
    B, N, L = bargs.batch, bargs.decode, s.cfg.num_layers
    print(f"W8 bench (Qwen3-4B, W8 + int8 KV, B={B}, prompt {bargs.prompt}, {N} steps): "
          f"{res['tok_s']:.1f} tok/s, walls {res['walls_s']} s, prefill {res['prefill_s'] * 1e3:.1f} ms, "
          f"decode step {res['step_ms']:.2f} ms, peak memory {res['peak_gib']:.2f} GiB | {res['card']}", flush=True)
    print(f"W8 bench launches in one generate: {json.dumps(counts)}", flush=True)
    want = dict(fused_qkv_w8=L * N, fused_linear_w8=L * N, fused_mlp_w8=L * N, fused_head_argmax=N + 1,
                decode_attention=L * N, flash_fwd=L)
    if counts != want:
        raise AssertionError(f"W8 bench launch counts {counts}, expected {want}")
    t0, t1 = res["tokens"]
    if t0.shape != (B, N) or not np.array_equal(t0, t1) or not ((t0 >= 0) & (t0 < s.cfg.vocab_size)).all():
        raise AssertionError("W8 bench: the repeat run gave other tokens, or tokens out of range")
    gen_wall = min(res["walls_s"])
    profile_breakdown("W8 generate", lambda: bench.timed_generate(s), unprofiled_s=gen_wall)
    del s
    torch.cuda.empty_cache()
    return counts, res


def arkit_path(args):
    """The ARKit action-JSON path at full width: ``arkit.run_inference`` on
    ``configs/stage2_arkit.yaml`` under the constraint FSM, once without and
    twice with speculative decoding. Returns the launch counts of the plain
    run and of the first speculative run."""
    import torch

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference import arkit, engine, qa
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    stage = arkit_stage()
    L, N = stage.model.text.num_layers, ARKIT_NEW_TOKENS
    t0 = time.perf_counter()
    params = qa.load_model(stage, rng_seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    print(f"ARKit path: random init of {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tok = load_tokenizer(None)
    samples = load_arkit_samples(args.seed, stage.data.num_views)
    vc = stage.model.vision
    want_flash = vc.patch_depth + 2 * vc.num_layers + L

    def infer(spec, n=N, stats=None):
        return arkit.run_inference(params, stage, tok, samples, max_new_tokens=n, batch_size=4, verbose=False,
                                   constrained_json=True, speculative=spec, device="cuda", stats=stats)[0]

    runs = []
    for spec in (False, True, True):
        stats = []
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fa.launches = da.launches = da.verify_launches = 0
        t = time.perf_counter()
        res = infer(spec, stats=stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = dict(flash_fwd=fa.launches, decode_attention=da.launches, block_verify_attention=da.verify_launches)
        (batch,) = stats
        tokens, lengths, iters = batch["tokens"], batch["lengths"], batch["iterations"] or 0
        runs.append(dict(res=res, tokens=tokens, lengths=lengths, counts=counts, secs=secs, iters=iters))
        n_tok = int(lengths.sum())
        what = (f"speculative: {iters} iterations, {n_tok / max(iters, 1):.3f} tokens per iteration"
                if spec else f"plain: {counts['decode_attention'] // L} decode steps")
        print(f"ARKit path (constrained JSON, {what}): {secs:.3f} s, {n_tok} tokens (lengths {lengths.tolist()}), "
              f"launches {json.dumps(counts)}, max memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        want = dict(flash_fwd=want_flash, decode_attention=0 if spec else L * N,
                    block_verify_attention=L * iters if spec else 0)
        if counts != want or (spec and iters < 1):
            raise AssertionError(f"ARKit path (speculative={spec}): launch counts {counts}, expected {want}")
        for row, n in zip(tokens, lengths):
            text = tok.decode(row[:n], skip_special_tokens=True)
            if list(json.loads(text)) != SCHEMA_KEYS:
                raise AssertionError(f"ARKit path: a generation is not a schema object: {text!r}")
    plain, spec_a, spec_b = runs
    if spec_a["res"] != spec_b["res"] or not np.array_equal(spec_a["tokens"], spec_b["tokens"]):
        raise AssertionError("ARKit path: the speculative repeat gave other records")
    n_raw = sum(1 for r in plain["res"] if _parses_to_schema(r["raw_prediction"]))
    print(f"ARKit path: raw_prediction (the reference's brace match) parses to the schema in {n_raw}/"
          f"{len(plain['res'])} plain records; generations parse in all", flush=True)
    if spec_a["res"] == plain["res"] and np.array_equal(spec_a["tokens"], plain["tokens"]):
        print("ARKit path: speculative records and tokens identical to the plain constrained run's", flush=True)
    else:  # the first differing step of each row must be a near-tie of the plain run
        _, gaps = constrained_gaps(engine, lambda: infer(False))
        noise = schedule_witness(params, stage, tok, samples, plain["tokens"])
        limit = max(1e-3, 2 * noise)
        print(f"ARKit path: speculative tokens differ from the plain run's; with plain attention the two schedules' "
              f"logits differ by up to {noise:.3e} of max|logit| on the same tokens, so a flip needs a top-2 gap "
              f"under {limit:.3e}", flush=True)
        for b in range(len(plain["tokens"])):
            diff = np.nonzero(plain["tokens"][b] != spec_a["tokens"][b])[0]
            if len(diff):
                t = int(diff[0])
                print(f"ARKit path: row {b} differs first at step {t}: plain top-2 gap there {gaps[t, b]:.3e} "
                      f"of max|logit|", flush=True)
                if not gaps[t, b] < limit:
                    raise AssertionError(f"ARKit path: row {b} differs at a decisive step {t} ({gaps[t, b]:.3e})")
    # the profiler's bookkeeping grows with the kernel events (~1,800 an
    # iteration): profile a speculative run cut at ARKIT_PROFILE_TOKENS
    torch.cuda.synchronize()
    t = time.perf_counter()
    infer(True, ARKIT_PROFILE_TOKENS)
    torch.cuda.synchronize()
    profile_breakdown(f"ARKit speculative run ({ARKIT_PROFILE_TOKENS} new tokens)",
                      lambda: infer(True, ARKIT_PROFILE_TOKENS), unprofiled_s=time.perf_counter() - t)
    del params
    torch.cuda.empty_cache()
    return plain["counts"], spec_a["counts"]


def schedule_witness(params, stage, tok, samples, tokens) -> float:
    """How far the two decode schedules' logits differ on the same tokens,
    with no kernel of the path in them: after one prefill of the ARKit
    batch, six one-token decode steps (GEMMs at 4 rows) against one 7-token
    verify block (GEMMs at 28 rows) over the plain run's first tokens, both
    with qwen3's attention routed through the plain versions on the card.
    Returns the max over rows and positions of max|Δlogit| / max|logit|.

    The same verify block then runs with the block-verify kernel, each
    layer's call held to the plain version on the same inputs
    (``utils.agreement``, tol 2e-2); its logits' distance from the plain
    block is printed."""
    import contextlib

    import torch
    import torch.nn.functional as F

    from vggt_qwen3_tpu_torch.inference import arkit, batching
    from vggt_qwen3_tpu_torch.models import qwen3
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.utils.agreement import agreement

    cfg, K = stage.model.text, DRAFT_K + 1
    prompts = [arkit.prompt_for(s["question"]) for s in samples]
    pad_to = batching.max_prompt_len(tok, prompts)
    ids, mask = (torch.from_numpy(a).cuda() for a in batching.encode_prompts(tok, prompts, pad_to_len=pad_to))
    images = batching.stack_views(samples, stage.data.image_size, "cuda")
    emb, m2 = batching.spliced_prompt(params, stage, tok.convert_tokens_to_ids("<image>"), images, ids, mask)
    B, S, _ = emb.shape
    T = S + K
    am = F.pad(m2.int(), (0, K))
    pos = torch.clamp_min(torch.cumsum(m2.int(), -1) - 1, 0)
    blk = torch.from_numpy(np.ascontiguousarray(tokens[:, :K])).cuda()
    tpos = torch.arange(T, device="cuda")[None, None, :]
    jpos = torch.arange(K, device="cuda")
    block_mask = torch.where(tpos < S, am.bool()[:, None, :], (tpos - S) <= jpos[None, :, None]).int()

    @contextlib.contextmanager
    def attention(decode, verify):  # what qwen3's decode steps and verify blocks call
        real = qwen3.gqa_decode_attention, qwen3.gqa_block_verify_attention
        qwen3.gqa_decode_attention, qwen3.gqa_block_verify_attention = decode, verify
        try:
            yield
        finally:
            qwen3.gqa_decode_attention, qwen3.gqa_block_verify_attention = real

    held = []

    def checked_verify(*a):  # the kernel's output, held to the plain version's on its inputs
        got = da.gqa_block_verify_attention(*a)
        held.append(agreement(got, da.gqa_block_verify_attention_plain(*a)))
        return got

    def verify_block(cache):
        return qwen3.forward(params["text"], cfg, input_ids=blk, attention_mask=block_mask,
                             positions=pos[:, -1:] + 1 + jpos[None, :], cache=cache,
                             cache_offset=torch.full((B,), S, device="cuda"), decode_frontier=True)[0]

    with torch.inference_mode():
        cache0 = qwen3.init_cache(cfg, B, T, device="cuda")
        qwen3.forward(params["text"], cfg, inputs_embeds=emb, attention_mask=am, positions=pos, cache=cache0,
                      prefill_padding="left", last_logit_only=True)

        def fresh():
            return {n: t.clone() for n, t in cache0.items()}

        with attention(da.gqa_decode_attention_plain, da.gqa_block_verify_attention_plain):
            cache, step_mask, steps = fresh(), am.clone(), []
            for j in range(K - 1):
                step_mask[:, S + j] = 1
                logits, cache = qwen3.forward(params["text"], cfg, input_ids=blk[:, j:j + 1],
                                              attention_mask=step_mask, positions=pos[:, -1:] + 1 + j, cache=cache,
                                              cache_offset=S + j, decode_frontier=True)
                steps.append(logits[:, 0])
            verify_plain = verify_block(fresh())
        with attention(da.gqa_decode_attention, checked_verify):
            verify_kernel = verify_block(fresh())
    step_logits = torch.stack(steps, dim=1)  # [B, K-1, V]: after tokens 0..K-2

    def rel(a, b):
        return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())

    worst = max(held, key=lambda h: h["rel_rms"])
    print(f"ARKit path: verify block with the kernel vs with the plain version: logits differ by up to "
          f"{rel(verify_kernel, verify_plain):.3e} of max|logit|; each of {len(held)} kernel calls held to the "
          f"plain version on its inputs, worst {json.dumps(worst)}", flush=True)
    if len(held) != cfg.num_layers or not all(h["ok"] for h in held):
        raise AssertionError("ARKit path: the block-verify kernel disagrees with its plain version in the verify block")
    return rel(verify_plain[:, :K - 1], step_logits)


def _parses_to_schema(text: str) -> bool:
    try:
        return list(json.loads(text)) == SCHEMA_KEYS
    except (ValueError, TypeError):
        return False


def profile_breakdown(label: str, run, unprofiled_s: float, range_family=None):
    """One more run of a main-path phase under torch.profiler: device time by
    kernel family and by kernel. The profiler slows the host, so the idle
    share is also given against ``unprofiled_s``, the same run's wall time
    without it. With ``range_family``, the kernels launched by ops inside the
    ``record_function`` range of that name count to that family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    events = prof.events()
    by_name, ranged = {}, {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:  # a range's span is no kernel
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        elif range_family is not None and e.kernels and _in_range(e, range_family):
            for k in e.kernels:
                ranged[k.name] = ranged.get(k.name, 0.0) + k.duration
    if range_family is not None and not ranged:
        print(f"profile {label}: no kernel was launched inside the {range_family!r} range", flush=True)
    busy = sum(by_name.values())
    if busy <= 0:
        print(f"profile {label}: the profiler saw no device time", flush=True)
        return

    def family(name):
        n = name.lower()
        if "flash_fwd_kernel" in n:
            return "flash_fwd (ours)"
        if "flash_bwd_dq_kernel" in n:
            return "flash_bwd_dq (ours)"
        if "flash_bwd_dkv_kernel" in n:
            return "flash_bwd_dkv (ours)"
        if "decode_kernel" in n:
            return "decode_attention (ours)"
        if "verify_kernel" in n:
            return "block_verify_attention (ours)"
        if "w8_gemm_kernel" in n:
            return "W8 GEMM w8_gemm: qkv, wo, down (ours)"
        if "w8_swiglu_kernel" in n:
            return "W8 gate/up w8_swiglu (ours)"
        if "head_tile_kernel" in n or "head_reduce_kernel" in n:
            return "head_argmax (ours)"
        if any(w in n for w in ("gemm", "nvjet", "sm90_", "cutlass", "cublas", "xmma", "gemv")):
            return "matmul (cuBLAS)"
        return "other (elementwise, norms, copies, reductions)"

    fam = {}
    for n, us in by_name.items():
        if n in ranged:
            fam[range_family] = fam.get(range_family, 0.0) + ranged[n]
            us -= ranged[n]
        fam[family(n)] = fam.get(family(n), 0.0) + us
    print(f"profile {label}: device busy {busy / 1e6:.3f} s; wall {wall_us / 1e6:.3f} s profiled "
          f"(idle share {max(0.0, 1 - busy / wall_us):.3f}), {unprofiled_s:.3f} s unprofiled "
          f"(idle share {max(0.0, 1 - busy / 1e6 / unprofiled_s):.3f})", flush=True)
    for f_name, us in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"profile {label} family: {f_name}: {us / 1e3:.1f} ms ({us / busy:.3f})", flush=True)
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile {label} kernel: {n[:90]}: {us / 1e3:.1f} ms ({us / busy:.3f})", flush=True)


def _in_range(event, name: str) -> bool:
    """Whether a profiled host op runs inside a ``record_function`` range ``name``."""
    while event is not None:
        if event.name == name:
            return True
        event = event.cpu_parent
    return False


def _to_device(tree, dev):
    return {k: _to_device(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_new_tokens", type=int, default=32)
    ap.add_argument("--tiles", choices=sorted(TILES), default=None,
                    help="only time this source's kernels, built with each set of nvcc defines in TILES")
    ap.add_argument("--w8_gemm", action="store_true",
                    help="only check and time the W8 layer kernels (QKV, WO, the MLP's two launches)")
    ap.add_argument("--package_root", default=None,
                    help="import the port from this directory (another tree of the repo, such as a parent "
                         "commit unpacked with git archive), to time its kernels in the same call")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "vggt_qwen3_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    if args.package_root:
        root = Path(args.package_root).resolve()
        if not (root / "vggt_qwen3_tpu_torch" / "csrc").is_dir():
            print(f"chip_smoke: {root} holds no vggt_qwen3_tpu_torch/csrc", file=sys.stderr)
            return 1
        sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phases = {}

    def phase_done(name):  # seconds since the previous phase ended
        phases[name] = round(time.perf_counter() - t_start - sum(phases.values()), 1)

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference.batching import max_prompt_len
    from vggt_qwen3_tpu_torch.ops import kernel_build

    libs = kernel_build.build(["flash_fwd", "flash_bwd", "decode_attention", "block_verify", "decode_matmul"])
    for kl in libs:
        print(f"built {kl.name} in {kl.build_seconds:.1f} s -> {kl.path.name}", flush=True)
        for line in kl.ptxas_log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "Performance Loss")):
                print(f"  ptxas: {line.strip()}", flush=True)

    phase_done("build")
    stage = full_stage()
    if args.tiles or args.w8_gemm:
        import vggt_qwen3_tpu_torch

        source = args.tiles or "decode_matmul"
        times = tiles(source, stage, torch.Generator(device="cuda").manual_seed(args.seed), variants=not args.w8_gemm)
        print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"tiles": source, "times": times,
                          "package": str(Path(vggt_qwen3_tpu_torch.__file__).parent)}), flush=True)
        return 0
    # the sources redesigned for Hopper (those TILES sweeps) build with no spill
    spilled = {kl.name: ptxas_spills(kl) for kl in libs if kl.name in TILES and ptxas_spills(kl)}
    if spilled:
        raise AssertionError(f"ptxas spills: {spilled}")
    # main-path shapes: 8 prompts, left-padded, 128 vision tokens spliced in
    tok = load_tokenizer(None)
    samples = load_samples(args.seed)
    lens = [len(tok(f"{s['question']}\n<image>\n")["input_ids"]) for s in samples]
    pad_to = max_prompt_len(tok, [f"{s['question']}\n<image>\n" for s in samples])
    S = pad_to + stage.model.num_vis_tokens - 1
    starts = [pad_to - n for n in lens]
    T = S + args.max_new_tokens
    txt, vis = stage.model.text, stage.model.vision
    tpf = vis.patch_start_idx + (stage.data.image_size // vis.patch_size) ** 2  # 1029 at 448²
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    B, V, vd = 8, stage.data.num_views, vis.embed_dim // vis.num_heads  # the QA batch: 8 samples x 8 views
    flash = {
        "vggt_frame": check_flash("vggt_frame", B * V, tpf, tpf, vis.num_heads, vis.num_heads, vd,
                                  causal=False, starts=[0] * (B * V), gen=gen),
        "vggt_global": check_flash("vggt_global", B, V * tpf, V * tpf, vis.num_heads, vis.num_heads, vd,
                                   causal=False, starts=[0] * B, gen=gen),
        "qwen3_prefill": check_flash("qwen3_prefill", B, S, S, txt.num_heads, txt.num_kv_heads, txt.head_dim,
                                     causal=True, starts=starts, gen=gen),
    }
    decode = {
        kv: check_decode(kv, txt.num_layers, B, txt.num_heads, txt.num_kv_heads, T, txt.head_dim,
                         min(17, txt.num_layers - 1), starts, quant=kv == "int8", gen=gen)
        for kv in ("bf16", "int8")
    }
    # the ARKit verify shape: 4 scenes, prompts left-padded, the Perceiver's
    # 128 latents spliced in, a cache of ceil((S + N + k) / 32) · 32 slots
    from vggt_qwen3_tpu_torch.inference.arkit import prompt_for
    from vggt_qwen3_tpu_torch.inference.batching import encode_prompts

    arkit_q = [r["instruction"] for r in json.loads((REPO / ARKIT_SCENES).read_text())[:4]]
    _, arkit_mask = encode_prompts(tok, [prompt_for(q) for q in arkit_q], pad_to_len=0)
    S_a = arkit_mask.shape[1] + stage.model.projector.num_latents - 1
    T_a = -(-(S_a + ARKIT_NEW_TOKENS + DRAFT_K) // 32) * 32
    a_starts = (arkit_mask.shape[1] - arkit_mask.sum(-1)).tolist()
    a_starts[2] = S_a + 202  # row 2: queries 0 and 1 see no slot
    a_offs = [S_a + 300, S_a + 117, S_a + 200, S_a + ARKIT_NEW_TOKENS - 1]
    verify = {
        kv: check_verify(kv, txt.num_layers, 4, txt.num_heads, txt.num_kv_heads, T_a, txt.head_dim, DRAFT_K + 1,
                         min(17, txt.num_layers - 1), a_starts, a_offs, quant=kv == "int8", gen=gen)
        for kv in ("bf16", "int8")
    }
    w8 = check_w8(txt, 368, gen)  # the W8 bench shape: 368 rows
    torch.cuda.empty_cache()
    bwd = backward_checks(stage, gen)  # kernels 8 and 9 and kernel 1's lse
    phase_done("kernel checks")
    reference_check(args.seed)
    reference_check_w8(args.seed)
    reference_check_speculative(args.seed)
    reference_check_train(args.seed)
    phase_done("card-vs-CPU checks")
    runs = main_path(args)
    phase_done("QA path")
    w8_counts, _ = w8_bench_path(args)
    phase_done("W8 bench path")
    arkit_plain, arkit_spec = arkit_path(args)
    phase_done("ARKit path")
    train = train_path(args)
    phase_done("training path")

    f, d = flash["vggt_global"], decode["bf16"]
    lse = bwd["vggt_global"]["flash_fwd_lse"]
    kernels = [
        dict(name="flash_fwd", route="cuda", source="vggt_qwen3_tpu_torch/csrc/flash_fwd.cu",
             replaces=FLASH_REPLACES, launches=runs[None][0], **f, lse_shape=lse["shape"],
             lse_ms=lse["ms_with_lse"], no_lse_ms=lse["ms_without"], training_launches=train["counts"]["flash_fwd"]),
        dict(name="decode_attention", route="cuda", source="vggt_qwen3_tpu_torch/csrc/decode_attention.cu",
             replaces=DECODE_REPLACES, launches=runs[None][1], **d),
        dict(name="block_verify_attention", route="cuda", source="vggt_qwen3_tpu_torch/csrc/block_verify.cu",
             replaces=VERIFY_REPLACES, launches=arkit_spec["block_verify_attention"], **verify["bf16"]),
    ] + [dict(name=n, route="cuda", source=W8_SOURCE, replaces=W8_REPLACES[n], launches=w8_counts[n], **w8[n])
         for n in W8_REPLACES] + [
        dict(name=n, route="cuda", source=BWD_SOURCE, replaces=BWD_REPLACES[n], launches=train["counts"][n],
             **bwd["vggt_global"][n]) for n in BWD_REPLACES]
    print(f"int8-cache run launches: flash {runs['int8'][0]}, decode {runs['int8'][1]}", flush=True)
    print(f"ARKit plain constrained run launches: {json.dumps(arkit_plain)}", flush=True)
    print(f"training run (freeze_vision false, {2 * TRAIN_GRAD_ACCUM} micro steps) launches: "
          f"{json.dumps(train['counts'])}; a micro step: {train['per_step']}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s, by phase {json.dumps(phases)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
