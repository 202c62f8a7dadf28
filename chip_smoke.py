#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--max_new_tokens 32]
    python3 chip_smoke.py --tiles flash_fwd|flash_bwd|decode_matmul|decode_attention [--build NAME] [--package_root DIR]
    python3 chip_smoke.py --w8_bench [--package_root DIR]

Run from the root of a checkout. It:

1. prints the card (name, ``nvidia-smi`` power limit);
2. builds the CUDA sources of the port from ``vggt_qwen3_tpu_torch/csrc``
   (flash forward, the two flash backward kernels, decode and block-verify
   attention, the four W8 decode kernels) with ``nvcc`` for sm_90a, in
   parallel, prints the ptxas report and fails on a spill in the sources
   redesigned for Hopper (``TILES``: flash_fwd, flash_bwd, decode_matmul,
   decode_attention);
3. holds each kernel against its plain PyTorch version at its main path's
   shapes (``utils.agreement``, tol 2e-2 scaled to the reference: every
   element within 2e-2·max|ref| + 2e-2·|ref|, and ‖err‖₂ ≤ 5e-3·‖ref‖₂;
   decode attention and block verify ‖err‖₂ ≤ 2e-4·‖ref‖₂; rows with no
   valid key exactly 0; the W8 head: the same token on every row whose
   top-2 gap exceeds 1e-4·max|logit|, at least 99 % of the rows), failing
   where a kernel's device time reads below its bound,
   timing on the device (``torch.profiler``) the kernel, the plain version
   and one PyTorch library call that computes the same function
   (``scaled_dot_product_attention``; ``torch.mm`` over a bf16 copy of the
   W8 weight dequantized outside the timed region — timed only as
   yardsticks, the port never calls them), and the wrapper's call with CUDA
   events (host included). Kernels that read a stacked per-layer tensor are
   timed with the layer index turning over the layers, so each launch reads
   a layer the one before did not, as in a decode step;
   The decode kernel runs at the QA decode step's shape (bf16 and int8
   caches) and at the W8 bench's (int8 [36, 368, 8, 160, 128], every
   frontier at 97; SDPA over a bf16 copy dequantized outside the timed
   region is its yardstick); the block-verify kernel at the ARKit verify
   shape (q [4, 7, 32, 128] over [36, 4, 8, 832, 128]) with bf16 and int8
   caches, ragged starts and offsets, a row whose first queries see no slot
   (exactly 0) and 1e4 in every slot no query sees; each shape's cut
   (``attention_plan``: splits of a row's cache, warps, shared memory) is
   printed on a line of its own. The four W8 kernels run at the bench shape
   (368 rows) and at 8 rows (the QA path's W8 decode step), the MLP's two
   launches also timed apart (gate/up, beside ``torch.mm`` over gate|up and
   silu·mul; the down w8_gemm, beside ``torch.mm``), two launches of each on
   the same inputs equal bit for bit; the kernel's cut of each w8_gemm and
   gate/up launch (``w8_gemm_plan``), the bounds of the MLP's two launches and
   of the 8-row shapes, and a fingerprint of the w8_gemm outputs' bits (to
   hold two trees' builds to the same bits) are printed on lines of their own. The flash forward runs
   at the QA batch's VGGT frame [64, 1029, 16, 64] and global
   [8, 8232, 16, 64] shapes, the training global shape with its lse output
   (within 1e-3 of the plain version's, exactly -1e30 on dead rows), the
   QA prefill (causal, left-padded, 32/8 heads, D = 128), the W8 bench's
   prefill (368 prompts of 32 tokens) and the root ring mode's 32-view shape
   [1, 32·1029, 16, 64] (with and without lse; its first and last 1024
   query rows held to the plain version over every key, which cannot run
   whole: ~69 GB of scores), each with its
   bound beside the floor of its exponentials on a line of its own
   (``flash_fwd_floors``). The flash backward
   kernels (dq; dk/dv) and the
   forward's lse output (their input: within 1e-3, -1e30 on dead rows) run at the training shapes — VGGT frame
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
   1e-4·max|logit|); the slot engine (int8 cache, batched and mid-decode
   admission, plain and speculative chunks; the same rule per request); and
   the training step (bf16, the tower unfrozen, 4 micro
   steps at grad_accum 2: losses, grad norms, the vision gradients, the
   updates), the same 4 micro steps on the card through the meshed step of
   a 1-rank NCCL world (``state_shardings`` on ``build_mesh(None)``: bit for
   bit the unmeshed card run's losses, grad norms and parameters), then
   saves that meshed train state (``checkpoint.save``: each rank's shards,
   here the one's) and restores it onto the mesh (every leaf bit for bit)
   and checks the next steps; and the W8A8 and W4 modes (``reference_check_quant``: the W8A8
   int32 product and output bit for bit at 1, 8, 17 and 368 rows, W4
   ``linear`` by ``utils.agreement``, penalised ``generate_text`` tokens);
5. drives the QA path at full width — Qwen3-4B, VGGT-1B, the perceiver_small
   projector, 8 samples × 8 views × 448², random weights from ``--seed`` —
   through ``inference.qa.run_inference`` with the bf16 cache (the CLI
   default, "the main path") and with the int8 cache, with every launch
   counter set to 0 just before and read just after each run, and repeats
   each run to check the tokens are identical; then once with W8 weights
   (``quantize=True``), and once more with qkvo LoRA adapters on the W8
   weights (the fused MLP still runs; QKV and WO take the plain product);
   and a device-only profile of one QA batch;
6. drives the W8 decode path at full width through
   ``vggt_qwen3_tpu_torch.bench`` (Qwen3-4B, W8 weights, int8 cache,
   B=368, prompt 32, 128 greedy steps): tokens/s, the decode step, peak
   memory, the launch counts of one timed ``generate`` (counters set to 0
   just before it), tokens identical on the repeat, and a device-only
   profile by kernel family of a ``W8_PROFILE_STEPS``-step generate;
6b. drives the W8A8 and W4 modes and text generation at full width
   (``quant_path``): the bench with ``--quant w8a8`` (B=368, 128 steps, int8
   cache; after a 2-step warm-up, tok/s of one timed generate and the
   decode step beside the W8 bench's, launches of kernels 1, 2 and 7 as the
   shapes give them and none of kernels 4–6, tokens identical on one repeat,
   a device-only 2-step profile); the quality gate
   ``evals.baseline.evaluate`` on the placeholder test splits (one bf16 pass
   against W8A8 and against W4 with an int8 cache, 32 new tokens, kernels
   4–6 never launched in a quantized run); one QA batch with
   ``vlm.quantize_vision("w8a8")`` beside ``"w8"`` (vision times); and
   ``engine.generate_text`` with the prompt penalised (8 × 64 ids, 32
   tokens, bf16, identical on the repeat);
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
   kernel call to the plain version on its inputs (the plain run records
   its top-2 gaps as it runs); then a profile of one speculative run cut at
   ``ARKIT_PROFILE_TOKENS`` new tokens;
8. drives the serving path at full width through the port's HTTP server
   (``inference.server``, ``ThreadingHTTPServer`` on a free localhost port)
   on the stage of ``configs/stage1_3d.yaml`` with the server's defaults
   (``qwen3.quantize_params`` W8 text weights, ``vlm.quantize_vision("w8")``,
   int8 KV cache; 8 slots, 32 new tokens, prompt bucket 64, decode chunk 4,
   byte tokenizer; the image loader replaced by one that returns seeded
   views): 12 ScanQA requests through the slots service, 8 at once and 4
   once the first chunk ran (two with budgets 8 and 16), asserting 200s,
   ``/healthz``, a mid-decode admission and every launch count;
   requests/s and p50/p95 latency (HTTP, and the engine's
   ``track_metrics``); a window of 2 requests to the slots service and 1 to
   the speculative one, 8 new tokens each, under the profiler (device busy
   and idle share, device-only tracing; each of our families' launches must
   all be seen); each request's tokens held to ``engine.generate`` of its
   spliced prompt at B = 1 (identical, or first different at a step whose
   top-2 gap is under 1e-3·max|logit|, or under twice the larger of two
   logit distances on the same tokens teacher-forced: the serving schedules
   — 8 rows in a 256-slot cache, decode steps and a 56-row verify block —
   against B = 1 with the plain attention versions, and the kernels against
   the plain versions on those schedules, every kernel call there held to
   its plain version on its inputs); the same 12 requests through the
   speculative slots service (kernel 3; its tokens held to the slots run's
   by the same rule) and 8 through the batch service; on
   each slot engine a registered prefix and two requests on it (the chunked
   prefill and steps over holed rows: kernels 1–3 must not launch after it,
   the W8 kernels must);
9. drives the SFT training path at full width through the trainer's entry
   points on the stage of ``configs/stage1_3d.yaml`` (``train_stage``: 6.18 B
   params, LoRA r16 on qkvo, text layers 0-3 frozen; 2 rows a micro step,
   grad_accum 2, a 4-step schedule; ScanQA/SQA3D placeholder records with
   seeded views, view dropout 0.3, Perceiver dropout 0.1): the recipe as
   shipped (tower frozen) for 2 micro steps, then ``freeze_vision`` false for
   4 (2 updates), asserting the launches of every micro step (72 flash
   forwards frozen; 144 forwards, 72 dq and 72 dk/dv unfrozen — the forward
   and its recompute), finite losses, frozen leaves bit-identical, and every
   trainable leaf changed unless its update is under half a bf16 ulp
   everywhere; micro-step wall time, tokens/s, peak memory and a device-only
   profile of one micro step with its update (between two marker kernels),
   one session. The state is made straight into its shards
   (``init_train_state(mesh=...)``) and every step runs through the meshed step
   (``make_train_step(state_sharding=state_shardings(state,
   build_mesh(None)))``) on a 1-rank NCCL world; then one call of the sft
   CLI (``train.sft.main(... --fsdp 1 --tiny --mock_vision --max_steps 2
   --device cuda)``) checks its mesh wiring on NCCL;
9b. the training recipes (``train_recipes_path``): (a) the bench's train
   mode (``bench.train_setup`` / ``train_micro`` / ``train_measure``) at the
   stage-1 recipe's micro batch (``recipe_stage``: B 6, 8 views × 448², text
   512, LoRA r16 on qkvo, the tower W8A8 and the Qwen3 base W8 frozen,
   8-bit AdamW, full width and depth; a cycle of 2 micro steps and the
   update; the schedule's horizon cut to 4 updates so that the second runs
   at the peak learning rate): micro-step and cycle times (the least of
   ``RECIPE_MICRO_REPS`` micro steps and ``RECIPE_CYCLE_REPS`` cycle after
   their warm-ups), the update residual, the recipe step (32 micro steps
   and the residual), text tokens/s, MFU against 989 TFLOP/s, peak memory, 72 flash forwards a micro
   step and no other launch, frozen leaves unmoved and trainable ones moved,
   and a device-only profile of one cycle (the optimizer's kernels between
   marker kernels); (b) ``configs/stage2_arkit.yaml`` (``stage2_train_stage``:
   LoRA r32 on q/v/o, layers 0-1 frozen, 10 views, text 4096; 2 rows a micro
   step, grad_accum 2) through ``init_train_state``, ``sft.build_data`` over
   the ARKit placeholder split (its records and JPEGs through the port's
   readers; the decoder backend that ran is printed) and
   ``make_train_step``, 2 micro steps and one update (kernel 1 is held to
   its plain version and timed at that run's global attention,
   [2, 10290, 16, 64], among the kernel checks of step 3,
   ``stage2_flash_check``); (c) ``reference_check_adam8bit``: the 8-bit update on
   the card against the CPU, on the same gradients and in a small bf16
   trainer run;
9c. the root bench's other modes (``bench_modes_path``): e2e, qa, spec,
   serve, serve_sla and ring through ``vggt_qwen3_tpu_torch.bench``'s mode
   functions at full width with the root bench's shapes and defaults (W8
   text, int8 KV where the root has it), on one seeded W8 VLM tree (serve and
   serve_sla take its text), a warm-up and 1 timed repetition instead of the
   root's warm-up and 3–5, and serve_sla's loads of 32 requests instead of 96;
   each mode's figures on a line, its launches (counters set to 0 just
   before and read just after) held to ``bench_mode_launches_ok`` (kernel
   1's count exact, from the shapes, repetitions and admissions), the first
   launch of each kernel at every shape the mode gives it held to its plain
   version after the run (``first_launches``), and its output to
   ``bench_mode_output_ok``;
10. prints the kernels line (with each kernel's launches on the serving
   path, ``serve_launches``, in one timed W8A8 bench ``generate``,
   ``w8a8_bench_launches``, in the bench train mode's run,
   ``train_recipe_launches``, in the stage-2 run, ``stage2_launches``, and
   in each bench mode's run, ``bench_modes_launches``, with the shapes held
   there and their largest error, ``bench_modes_held``; kernel 1 with its
   stage-2 global shape's and the ring shape's times), the card line and,
   last, the ok line.

Any failure raises and the script exits non-zero. Without a CUDA device, or
outside a checkout of the repo, it exits non-zero before printing a result.

With ``--tiles SOURCE`` it runs only the checks of step 3 that time the
kernels of ``csrc/SOURCE.cu``, once for each build in ``TILES[SOURCE]``
(tile, ring and cut sizes set with nvcc defines), the source's own first and
last so that the spread of the call shows beside the differences, each
build in a process of its own: ``flash_bwd`` runs the flash backward at its
three shapes, ``decode_matmul`` the four W8 kernels at 368 and 8 rows (QKV,
WO, the MLP whole and its two launches, the head), ``decode_attention`` kernels 2 and
3 at the QA, W8 and ARKit shapes, ``flash_fwd`` kernel 1 at the VGGT global,
training (with lse) and frame shapes and the QA and W8 prefills. ``--build NAME`` runs one build alone:
``own`` (the source's defines) or a name of ``TILES[SOURCE]``.
``--w8_bench`` drives only the W8 bench path (tok/s, decode step, launch
counts, profile by kernel family). ``--package_root DIR`` imports the port
from DIR instead (another tree, such as the parent commit unpacked with
``git archive``), so that two trees are timed on one card: parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import itertools
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak
H100_SMS = 132
H100_EXP_PER_SM_CLOCK = 16   # ex2 on the special function units: 4 quadrants x 4 a clock
FLASH_REPLACES = "vggt_qwen3_tpu/ops/flash_attention.py:41"
FLASH_SOURCE = "vggt_qwen3_tpu_torch/csrc/flash_fwd.cu"
DECODE_REPLACES = "vggt_qwen3_tpu/ops/decode_attention.py:55"
VERIFY_REPLACES = "vggt_qwen3_tpu/ops/decode_attention.py:317"
ARKIT_SCENES = "data/processed/arkit_synth/test.json"
SCHEMA_KEYS = ["action", "scene", "center", "normal", "extent"]
DRAFT_K = 6  # generate_batch's default verify block: k + 1 = 7 queries
ARKIT_NEW_TOKENS = 340  # every constrained object closes within 340 byte tokens
ARKIT_PROFILE_TOKENS = 64  # the profiled speculative ARKit run, cut short: its verify iterations repeat one another
W8_PROFILE_STEPS = 32  # the W8 bench's profiled generate, cut short: every decode step of it is the same step
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
# 80 rows when K has fewer than 48 steps), and other row groups of the head
# (its own: at most 184 rows)
W8_GEMM_TILES = {
    "one_part_rows_96": {"W8_ONE_PART_ROWS": 96},
    "one_part_rows_64": {"W8_ONE_PART_ROWS": 64},
    "wide_parts_2": {"W8_WIDE_PARTS": 2},
    "wide_parts_8": {"W8_WIDE_PARTS": 8},
    "small_part_steps_5": {"W8_SMALL_PART_STEPS": 5},
    "small_part_steps_20": {"W8_SMALL_PART_STEPS": 20},
    "head_rows_128": {"HEAD_MAX_ROWS": 128},
    "head_rows_64": {"HEAD_MAX_ROWS": 64},
}
# other tile, ring and warpgroup counts of kernel 1 (csrc/flash_fwd.cu) and
# its two overlaps, as the nvcc defines it reads (its own: at D = 64 three
# consumer warpgroups of 64 rows, 128-key stages and a ring of 3; at D = 128
# two warpgroups, 64 keys, a ring of 2; both overlaps on)
FLASH_FWD_TILES = {
    "consumers_2": {"FWD_CONSUMERS_64": 2},
    "keys_64": {"FWD_KEYS_64": 64},
    "stages_2": {"FWD_STAGES_64": 2},
    "stages_4": {"FWD_STAGES_64": 4},
    "no_overlap": {"FWD_OVERLAP": 0},
    "no_pingpong": {"FWD_PINGPONG": 0},
    "d128_keys_128": {"FWD_KEYS_128": 128},
    "d128_stages_3": {"FWD_STAGES_128": 3},
}
# other tile, ring and split sizes of kernels 2 and 3 (csrc/decode_attention.cu),
# as the nvcc defines it reads (its own: 32-slot tiles, a ring of 2, at most 8
# splits a row)
ATTENTION_TILES = {
    "tile_64_slots": {"TILE_SLOTS": 64},
    "ring_3": {"RING_STAGES": 3},
    "at_most_4_splits": {"PLAN_MAX_SPLITS": 4},
}
# ‖err‖₂ / ‖ref‖₂ that kernels 2 and 3 are held to: they keep P in f32 as a
# bf16 head and residual (the plain version's P to ~2^-16); P rounded to bf16
# once read 2.1e-3 at the QA shape on an H100, inside utils.agreement's 5e-3
ATTENTION_REL_RMS = 2e-4
ATTENTION_SOURCE = "vggt_qwen3_tpu_torch/csrc/decode_attention.cu"
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
    what a back-to-back loop of a short kernel measures. Where no profiler
    session saw every launch, the time is taken with CUDA events instead
    (host gaps included: never below the device time)."""
    return sum(device_ms_by_kernel(fn, iters, events_fallback=True).values())


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def held_to_plain(what: str, got, ref, rel_rms=None) -> dict:
    """The kernel's output against its plain version's, by the limits of
    ``utils.agreement`` and, where ``rel_rms`` is given, ‖err‖₂ ≤
    rel_rms·‖ref‖₂; raises if they disagree, else returns the errors beside
    their limits."""
    from vggt_qwen3_tpu_torch.utils.agreement import agreement

    out = agreement(got, ref)
    if rel_rms is not None:
        out["rel_rms_limit"] = min(out["rel_rms_limit"], rel_rms)
    if not out.pop("ok") or out["rel_rms"] > out["rel_rms_limit"]:
        raise AssertionError(f"{what} disagrees with its plain version: {out}")
    return out


def not_below_bound(what: str, ms: float, bms: float) -> None:
    """A device time below the least the card could take for the work is a
    fault of the measurement (a profiler session that missed launches):
    fail rather than report it."""
    if ms < bms:
        raise AssertionError(f"{what}: {ms} ms a launch reads below its bound of {bms} ms")


def check_flash(name, B, S, T, NH, NKV, D, *, causal, starts, gen, with_lse=False):
    """Kernel 1 against its plain version at one shape (with ``with_lse`` the
    lse output too, within 1e-3 and exactly -1e30 on dead rows, and the
    times are of the call that writes it); returns the measurement dict and
    prints the bound beside the floor of the exponentials on a line of its
    own (``flash_fwd_floors``)."""
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
            return fa.flash_attention_plain_with_lse(q, k, v, **kw)
        outs = [fa.flash_attention_plain_with_lse(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal,
                                                  kv_start=start[b:b + 1], kv_end=end[b:b + 1]) for b in range(B)]
        return torch.cat([o for o, _ in outs]), torch.cat([l for _, l in outs])

    def kernel():
        return fa.flash_attention_with_lse(q, k, v, **kw) if with_lse else fa.flash_attention(q, k, v, **kw)

    got = kernel()
    torch.cuda.synchronize()
    ref, ref_lse = plain()
    lse_err = None
    if with_lse:
        got, lse = got
        lse_live = ref_lse > -1e29
        lse_err = (lse[lse_live] - ref_lse[lse_live]).abs().max().item()
        if lse_err > 1e-3 or not (lse[~lse_live] == -1e30).all():
            raise AssertionError(f"flash_fwd lse[{name}]: max abs err {lse_err}, or a dead row not -1e30")
        del lse
    del ref_lse
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
    call_ms = cuda_ms(kernel, iters=10)
    ms = device_ms(kernel, iters=10)
    plain_ms = device_ms(plain, iters=2)
    library_ms = device_ms(lib, iters=10)
    # work this data needs: valid (query, key) pairs only
    if causal:
        pairs = sum((S - s0) * (S - s0 + 1) // 2 for s0 in starts)
    else:
        pairs = sum(S * (T - s0) for s0 in starts)
    flops = 4 * NH * D * pairs
    nbytes = 2 * (2 * B * S * NH * D + 2 * B * T * NKV * D)
    if with_lse:
        nbytes += 4 * B * NH * S
    bms, by = bound_ms(nbytes, flops)
    # one exponential per valid score on the SMs' special function units:
    # 16 a clock per SM at the card's highest SM clock
    exp_floor = NH * pairs / (H100_SMS * H100_EXP_PER_SM_CLOCK * sm_clock_hz()) * 1e3
    out = dict(shape=f"{name} q[{B},{S},{NH},{D}] kv[{B},{T},{NKV},{D}] causal={causal}"
                     + (" with lse" if with_lse else ""),
               **agree, ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bms, bound_by=by)
    if with_lse:
        out["lse_max_abs_err"] = lse_err
    print(f"flash_fwd_floors[{name}] bound_ms {bms:.4f} ({by}); exp_floor_ms {exp_floor:.4f}", flush=True)
    print(f"flash_fwd {json.dumps(out)}", flush=True)
    return out


PAD_KERNEL = "spin_kernel"  # the kernel of torch.cuda._sleep


class Parts:
    """A phase's seconds by part: ``mark(name)`` closes the part that ran
    since the previous mark; ``report(label)`` prints them on a line."""

    def __init__(self):
        self.t, self.secs = time.perf_counter(), {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.secs[name] = round(now - self.t, 1)
        self.t = now

    def report(self, label: str) -> None:
        print(f"{label} by part (s): {json.dumps(self.secs)}", flush=True)


def profiler_pad() -> None:
    """A few short kernels of ``torch.cuda._sleep`` at the end of a profiler
    session, after its work has finished: a session that loses its last
    device records then loses these. Their records are left out of every
    measurement (``PAD_KERNEL``)."""
    import torch

    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def device_ms_by_kernel(fn, iters: int, events_fallback: bool = False) -> dict:
    """Device time of one call of ``fn`` by kernel name (``torch.profiler``).
    A profiler session now and then records no device activity at all, or
    only part of it (a kernel seen a number of times that is not a multiple
    of ``iters``, which reads a time below the kernel's); such a session is
    run again, four times at most. If none of the five saw every launch,
    this raises, or with ``events_fallback`` times the ``iters`` calls with
    CUDA events and returns that one time under the name
    ``"all kernels (CUDA events)"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            profiler_pad()
        by, seen = {}, {}
        for name, start, end in device_events(prof):
            if PAD_KERNEL not in name:
                by[name] = by.get(name, 0.0) + (end - start) / 1e3 / iters
                seen[name] = seen.get(name, 0) + 1
        if by and all(n % iters == 0 for n in seen.values()):
            return by
        events.append(sum(seen.values()))
        time.sleep(0.2)  # let the profiler's last records drain before the next session
    if not events_fallback:
        raise AssertionError(f"every profiler session missed launches: {events} device events over {iters} calls")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    print(f"device_ms: every profiler session missed launches ({events} device events over {iters} calls); "
          f"timed with CUDA events: {ms} ms a call", flush=True)
    return {"all kernels (CUDA events)": ms}


def check_flash_backward(name, B, S, NH, NKV, D, *, causal, starts, ends, gen):
    """Kernels 8 and 9 (and the lse they are given, kernel 1's, within 1e-3
    of the plain version's and -1e30 on dead rows) against their plain
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
    plain_ms = device_ms(plain, iters=1)
    mask = (~outside)[:, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    # SDPA's backward kernels alone: the graph of one forward, differentiated repeatedly
    q_, k_, v_ = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
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
                             plain_ms=plain_ms, library_ms=library_ms, bound_ms=dq_bound, bound_by=dq_by,
                             lse_max_abs_err=lse_err),
        "flash_bwd_dkv": dict(shape=shape, **{f"dk_{a}": b for a, b in agree["dk"].items()},
                              **{f"dv_{a}": b for a, b in agree["dv"].items()},
                              max_abs_err=max(agree["dk"]["max_abs_err"], agree["dv"]["max_abs_err"]),
                              ms=dkv_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=dkv_bound,
                              bound_by=dkv_by),
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
    """check_w8 at the bench shape: device, call and host ms of QKV and WO at
    368 and 8 rows beside torch.mm's; the MLP whole and its two launches
    (gate/up, down) at 368 and 8 rows, and the head at 368 and 8 rows, each
    beside its library call; each w8_gemm launch's plan."""
    res = check_w8(stage.model.text, 368, gen)
    q, o, m, h = res["fused_qkv_w8"], res["fused_linear_w8"], res["fused_mlp_w8"], res["fused_head_argmax"]
    times = {}
    for key, r in (("qkv", q), ("wo", o)):
        for pre, sub in (("", ""), ("m8_", "_m8")):
            times.update({f"{key}{sub}": r[f"{pre}ms"], f"{key}{sub}_mm": r[f"{pre}library_ms"],
                          f"{key}{sub}_call": r[f"{pre}call_ms"], f"{key}{sub}_host": r[f"{pre}host_ms"]})
    for pre, sub in (("", ""), ("m8_", "_m8")):
        times.update({f"mlp{sub}": m[f"{pre}ms"], f"mlp{sub}_lib": m[f"{pre}library_ms"],
                      f"swiglu{sub}": m[f"{pre}swiglu_ms"], f"swiglu{sub}_lib": m[f"{pre}swiglu_library_ms"],
                      f"down{sub}": m[f"{pre}down_ms"], f"down{sub}_mm": m[f"{pre}down_library_ms"],
                      f"head{sub}": h[f"{pre}ms"], f"head{sub}_lib": h[f"{pre}library_ms"]})
    times["plans"] = res["plans_and_bounds"]["plans"]
    times["digests"] = res["digests"]
    return times


def attention_checks(stage, gen, seed: int = 0, max_new_tokens: int = 32) -> dict:
    """Kernels 2 and 3 at their main paths' shapes, bf16 and int8 caches:
    the QA decode step (8 prompts left-padded, the 128 vision tokens spliced
    in, T = prefill + new tokens, every row's end at T), the W8 bench's decode
    step (368 rows, int8, T = 160, starts 0, every row's end at 97: the mean
    frontier of its 128 steps) and the ARKit verify block (q [4, 7, 32, 128]
    over 832 slots, ragged starts and offsets, a row whose first queries see
    no slot)."""
    from vggt_qwen3_tpu_torch import bench
    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference.arkit import prompt_for
    from vggt_qwen3_tpu_torch.inference.batching import encode_prompts, max_prompt_len

    tok = load_tokenizer(None)
    txt = stage.model.text
    L, NH, NKV, D, li = txt.num_layers, txt.num_heads, txt.num_kv_heads, txt.head_dim, min(17, txt.num_layers - 1)
    questions = [f"{s['question']}\n<image>\n" for s in load_samples(seed, n_views=1, side=8)]
    lens = [len(tok(q)["input_ids"]) for q in questions]
    pad_to = max_prompt_len(tok, questions)
    T = pad_to + stage.model.num_vis_tokens - 1 + max_new_tokens
    res = {f"decode_{kv}": check_decode(kv, L, 8, NH, NKV, T, D, li, [pad_to - n for n in lens],
                                        quant=kv == "int8", gen=gen) for kv in ("bf16", "int8")}
    w8 = bench.parse_args([])
    res["decode_w8"] = check_decode("w8_int8", L, w8.batch, NH, NKV, w8.prompt + w8.decode, D, li, [0] * w8.batch,
                                    ends=[w8.prompt + 1 + w8.decode // 2] * w8.batch, quant=True, gen=gen)
    # the ARKit verify shape: 4 scenes, prompts left-padded, the Perceiver's
    # 128 latents spliced in, a cache of ceil((S + N + k) / 32) · 32 slots
    arkit_q = [r["instruction"] for r in json.loads((REPO / ARKIT_SCENES).read_text())[:4]]
    _, arkit_mask = encode_prompts(tok, [prompt_for(q) for q in arkit_q], pad_to_len=0)
    S_a = arkit_mask.shape[1] + stage.model.projector.num_latents - 1
    T_a = -(-(S_a + ARKIT_NEW_TOKENS + DRAFT_K) // 32) * 32
    a_starts = (arkit_mask.shape[1] - arkit_mask.sum(-1)).tolist()
    a_starts[2] = S_a + 202  # row 2: queries 0 and 1 see no slot
    a_offs = [S_a + 300, S_a + 117, S_a + 200, S_a + ARKIT_NEW_TOKENS - 1]
    for kv in ("bf16", "int8"):
        res[f"verify_{kv}"] = check_verify(kv, L, 4, NH, NKV, T_a, D, DRAFT_K + 1, li, a_starts, a_offs,
                                           quant=kv == "int8", gen=gen)
    return res


def attention_times(stage, gen) -> dict:
    """attention_checks' device ms of each shape, beside SDPA's, the bound and
    the rel RMS against the plain version."""
    return {name: dict(ms=r["ms"], library_ms=r["library_ms"], call_ms=r["call_ms"], bound_ms=r["bound_ms"],
                       rel_rms=r["rel_rms"]) for name, r in attention_checks(stage, gen).items()}


def qa_prefill(stage, seed: int):
    """The QA batch's prefill: its length S (8 prompts left-padded, the
    vision tokens spliced in) and each row's first valid slot."""
    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference.batching import max_prompt_len

    tok = load_tokenizer(None)
    prompts = [f"{s['question']}\n<image>\n" for s in load_samples(seed)]
    pad_to = max_prompt_len(tok, prompts)
    return pad_to + stage.model.num_vis_tokens - 1, [pad_to - len(tok(p)["input_ids"]) for p in prompts]


def flash_checks(stage, gen, seed: int = 0) -> dict:
    """Kernel 1 at its main paths' shapes: the QA batch's VGGT frame and
    global attentions (8 samples x 8 views), the training global attention
    with lse (2 samples), the QA prefill (causal, left-padded, GQA,
    D = 128) and the W8 bench's prefill (368 prompts of 32 tokens)."""
    from vggt_qwen3_tpu_torch import bench

    vis, txt = stage.model.vision, stage.model.text
    w8 = bench.parse_args([])
    tpf = vis.patch_start_idx + (stage.data.image_size // vis.patch_size) ** 2  # 1029 at 448²
    B, V, D, NH = 8, stage.data.num_views, vis.embed_dim // vis.num_heads, vis.num_heads
    S, starts = qa_prefill(stage, seed)
    return {
        "vggt_frame": check_flash("vggt_frame", B * V, tpf, tpf, NH, NH, D, causal=False, starts=[0] * (B * V),
                                  gen=gen),
        "vggt_global": check_flash("vggt_global", B, V * tpf, V * tpf, NH, NH, D, causal=False, starts=[0] * B,
                                   gen=gen),
        "train_global": check_flash("train_global", TRAIN_BATCH, V * tpf, V * tpf, NH, NH, D, causal=False,
                                    starts=[0] * TRAIN_BATCH, gen=gen, with_lse=True),
        "qwen3_prefill": check_flash("qwen3_prefill", B, S, S, txt.num_heads, txt.num_kv_heads, txt.head_dim,
                                     causal=True, starts=starts, gen=gen),
        "w8_prefill": check_flash("w8_prefill", w8.batch, w8.prompt, w8.prompt, txt.num_heads, txt.num_kv_heads,
                                  txt.head_dim, causal=True, starts=[0] * w8.batch, gen=gen),
    }


def flash_fwd_times(stage, gen) -> dict:
    """flash_checks' device ms of each shape, beside SDPA's, the bound and
    the rel RMS against the plain version."""
    return {name: dict(ms=r["ms"], library_ms=r["library_ms"], bound_ms=r["bound_ms"], rel_rms=r["rel_rms"])
            for name, r in flash_checks(stage, gen).items()}


# csrc/<source>.cu -> (its variants as nvcc defines, the check that times a build)
TILES = {"flash_fwd": (FLASH_FWD_TILES, flash_fwd_times), "flash_bwd": (FLASH_BWD_TILES, flash_bwd_times),
         "decode_matmul": (W8_GEMM_TILES, w8_gemm_times), "decode_attention": (ATTENTION_TILES, attention_times)}


def ptxas_spills(lib) -> list:
    """The lines of a build's ptxas report that show a spill."""
    return [ln.strip() for ln in lib.ptxas_log.splitlines() if "spill" in ln and " 0 bytes spill stores" not in ln]


def tiles(source: str, build: str, stage, gen) -> dict:
    """TILES[source]'s check for one build of csrc/<source>.cu: ``own`` (the
    source's defines) or a name of its table (nvcc defines). Fails on a ptxas
    spill in a build of this repo; another tree's build (``--package_root``)
    is timed with its spills beside its times."""
    import vggt_qwen3_tpu_torch
    from vggt_qwen3_tpu_torch.ops import kernel_build

    this_tree = Path(vggt_qwen3_tpu_torch.__file__).resolve().parents[1] == REPO
    table, check = TILES[source]
    lib = kernel_build.rebuild(source, table[build]) if build != "own" else kernel_build.load(source)
    spills = ptxas_spills(lib)
    if spills and this_tree:
        raise AssertionError(f"{source} {build}: ptxas spills: {spills}")
    times = check(stage, gen)
    if spills:
        times["ptxas_spills"] = spills
    return times


def sweep(source: str, package_root) -> dict:
    """:func:`tiles` for each build of TILES[source], the source's own first
    and last ("own", "own (again)"), each in a child process: in one process
    that loaded the builds one after another, the profiler sessions after
    the first load missed launches. Raises if a build fails."""
    runs = [("own", "own"), *((n, n) for n in TILES[source][0]), ("own (again)", "own")]
    times = {}
    for label, build in runs:
        cmd = [sys.executable, str(REPO / "chip_smoke.py"), "--tiles", source, "--build", build]
        if package_root:
            cmd += ["--package_root", package_root]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            raise AssertionError(f"--tiles {source} --build {build} failed (rc {proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
        times[label] = json.loads(proc.stdout.strip().splitlines()[-1])["times"]
        print(f"tiles {source} {label} {json.dumps(TILES[source][0].get(build, {}))} {json.dumps(times[label])}",
              flush=True)
    return times


def check_decode(name, L, B, NH, NKV, T, D, li, starts, *, quant, gen, ends=None):
    """The decode kernel against its plain version over the slots [start,
    end) of each row (``ends`` None: every row's end at T), timed with the
    layer index turning. The yardstick is SDPA over the same layer with a
    [B, 1, 1, T] boolean mask; for an int8 cache (no single library call
    reads one with its scales folded) SDPA over a bf16 copy dequantized
    outside the timed region, labelled so."""
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
    ends = [T] * B if ends is None else ends
    end = torch.tensor(ends, dtype=torch.int32, device="cuda")
    args = (q, k, v, li, start, end, ks, vs)
    got = da.gqa_decode_attention(*args)
    torch.cuda.synchronize()
    ref = da.gqa_decode_attention_plain(*args)
    agree = held_to_plain(f"decode_attention[{name}]", got, ref, rel_rms=ATTENTION_REL_RMS)
    del ref
    turn = layer_turns(L)
    if quant:  # layer by layer: a whole f32 copy of the W8 bench's cache would not fit beside it
        kd = torch.empty(k.shape, dtype=torch.bfloat16, device="cuda")
        vd = torch.empty(v.shape, dtype=torch.bfloat16, device="cuda")
        for i in range(L):
            kd[i] = (k[i].float() * ks[i].float()[..., None]).bfloat16()
            vd[i] = (v[i].float() * vs[i].float()[..., None]).bfloat16()
    else:
        kd, vd = k, v
    pos = torch.arange(T, device="cuda")
    mask = ((pos[None, :] >= start[:, None]) & (pos[None, :] < end[:, None]))[:, None, None, :]
    q4 = q[:, :, None]
    library_ms = device_ms(lambda: (lambda i: F.scaled_dot_product_attention(
        q4, kd[i], vd[i], attn_mask=mask, enable_gqa=True))(turn()), 2 * L)
    del kd, vd
    rotating = lambda: da.gqa_decode_attention(q, k, v, turn(), start, end, ks, vs)  # noqa: E731
    call_ms = cuda_ms(rotating, iters=2 * L)
    ms = device_ms(rotating, iters=2 * L)
    ms_one_layer = device_ms(lambda: da.gqa_decode_attention(*args), iters=20)  # one fixed layer, warm in L2
    plain_ms = device_ms(lambda: da.gqa_decode_attention_plain(q, k, v, turn(), start, end, ks, vs), iters=6)
    slots = sum(min(e, T) - min(s, T) for s, e in zip(starts, ends) if e > s)
    itemsize = 1 if quant else 2
    nbytes = 2 * slots * NKV * D * itemsize + (2 * slots * NKV * 2 if quant else 0) + 2 * 2 * B * NH * D
    bms, by = bound_ms(nbytes, 4 * NH * D * slots)
    not_below_bound(f"decode_attention[{name}]", ms, bms)
    out = dict(shape=f"{name} q[{B},{NH},{D}] cache[{L},{B},{NKV},{T},{D}] li turning over {L} layers",
               **agree, ms=ms, ms_one_layer=ms_one_layer, call_ms=call_ms, plain_ms=plain_ms,
               library_ms=library_ms, library="SDPA" + (" over a bf16 copy dequantized outside the timed region"
                                                        if quant else ""),
               bound_ms=bms, bound_by=by)
    print(f"decode_attention {json.dumps(out)}", flush=True)
    print_attention_plan(f"decode_attention[{name}]", B, 1, NH, NKV, T, D, quant)
    return out


def print_attention_plan(what, B, S, NH, NKV, T, D, quant):
    """The kernel's own cut of a launch (splits of each row's cache, warps,
    shared memory), on a line of its own; nothing for a tree whose kernel
    has no plan to report."""
    from vggt_qwen3_tpu_torch.ops import decode_attention as da

    if hasattr(da, "attention_plan"):
        print(f"attention plan {what}: {json.dumps(da.attention_plan(B, S, NH, NKV, T, D, quant))}", flush=True)


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
    agree = held_to_plain(f"block_verify_attention[{name}]", got[~empty], ref[~empty], rel_rms=ATTENTION_REL_RMS)
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
    not_below_bound(f"block_verify_attention[{name}]", ms, bms)
    out = dict(shape=f"{name} q[{B},{S},{NH},{D}] cache[{L},{B},{NKV},{T},{D}] li turning over {L} layers",
               **agree, empty_queries=int(empty.sum()), ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               library_ms=library_ms, library="SDPA, explicit mask" + (
                   " (over a bf16 copy dequantized outside the timed region)" if quant else ""),
               bound_ms=bms, bound_by=by)
    print(f"block_verify_attention {json.dumps(out)}", flush=True)
    print_attention_plan(f"block_verify_attention[{name}]", B, S, NH, NKV, T, D, quant)
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


def check_w8(cfg, M: int, gen, m_small: int = 8) -> dict:
    """The four W8 decode kernels at the bench shape (``cfg`` = Qwen3-4B,
    M = 368 rows) and at ``m_small`` rows (the QA path's W8 decode step),
    each against its plain version, timed with the layer index turning over
    the layers; the yardstick is ``torch.mm`` over a bf16 copy dequantized
    outside the timed region (for the head, + argmax). The MLP's two
    launches (gate/up, then the down w8_gemm) are also timed apart by kernel
    name, gate/up beside ``torch.mm`` over gate|up + silu·mul and down beside
    ``torch.mm``; two launches of each kernel on the same inputs must give
    the same bits. Under "plans_and_bounds" (printed on a line of its own,
    never in a kernel's record): each w8_gemm launch's plan and the bounds
    other than each record's own ``bound_ms``."""
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

    plans, bounds, digests = {}, {}, {}
    small_keys = ("max_abs_err", "rel_rms", "ms", "call_ms", "host_ms", "plain_ms", "library_ms")

    def digest(name, outs):
        """A fingerprint of a launch's output bits at layer li (two trees'
        builds on the same seeded inputs: equal fingerprints, equal bits)."""
        h = hashlib.sha256()
        for o in outs:
            h.update(o.contiguous().view(torch.int16).cpu().numpy().tobytes())
        digests[name] = h.hexdigest()[:16]

    def with_small(name, res, small, K):
        """A kernel's measured figures at m_small rows beside the bench
        shape's; the plans and the small shape's bound go aside."""
        res.update({f"m{m_small}_{k}": small[k] for k in small_keys if k in small})
        bounds[f"{name}_m{m_small}"] = (small["bound_ms"], small["bound_by"])
        if K is not None:
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
        digest(f"qkv_m{rows}", dm.fused_qkv_w8(xr, w["wq"], w["wk"], w["wv"], li))
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
        digest(f"wo_m{rows}", [dm.fused_linear_w8(ar, w["wo"], li)])
    out["fused_linear_w8"] = with_small("wo", out.pop(("wo", M)), out.pop(("wo", m_small)), NQ)
    del w_o
    w_gu = torch.cat([quant.dequantize(w["gate"]), quant.dequantize(w["up"])], dim=-1)
    w_d = quant.dequantize(w["down"])

    def gate_up_library(xr, i):
        gu = torch.mm(xr, w_gu[i])
        return F.silu(gu[:, :Fd]) * gu[:, Fd:]

    for rows, xr in ((M, xm), (m_small, xm[:m_small].contiguous())):
        def mlp(i, xr=xr):
            return (dm.fused_mlp_w8(xr, w["gate"], w["up"], w["down"], i),)

        res = measure(
            f"fused_mlp_w8 x[{rows},{H}] gate/up[{L},{H},{Fd}] down[{L},{Fd},{H}]", rows, mlp,
            lambda i, xr=xr: (dm.fused_mlp_w8_plain(xr, w["gate"], w["up"], w["down"], i),),
            lambda i, xr=xr: torch.mm(gate_up_library(xr, i), w_d[i]), 6 * rows * H * Fd,
            3 * H * Fd + 2 * (2 * Fd + H) + 2 * rows * H + 2 * rows * H, held("fused_mlp_w8"))
        # its two launches apart: gate/up (w8_swiglu) and the down projection (w8_gemm)
        by = device_ms_by_kernel(lambda: mlp(turn()), iters=2 * L)
        down_ms = sum(t for n, t in by.items() if "w8_gemm_kernel" in n)
        swiglu_ms = sum(t for n, t in by.items() if "w8_swiglu_kernel" in n)
        if down_ms <= 0 or swiglu_ms <= 0 or abs(down_ms + swiglu_ms - sum(by.values())) > 1e-9:
            raise AssertionError(f"fused_mlp_w8's kernels by name: {by}")
        ar = act[:rows].contiguous()
        res.update(swiglu_ms=swiglu_ms, down_ms=down_ms,
                   swiglu_library_ms=device_ms(lambda: gate_up_library(xr, turn()), iters=2 * L),
                   down_library_ms=device_ms(lambda: torch.mm(ar, w_d[turn()]), iters=2 * L))
        down_got, down_ref = dm.fused_linear_w8(ar, w["down"], li), dm.fused_linear_w8_plain(ar, w["down"], li)
        res["down_rel_rms"] = held_to_plain("w8_gemm (down)", down_got, down_ref)["rel_rms"]
        digest(f"down_m{rows}", [down_got])
        sfx = "" if rows == M else f"_m{m_small}"
        bounds[f"swiglu{sfx}"] = bound_ms(2 * H * Fd + 4 * Fd + 2 * rows * H + 2 * rows * Fd, 4 * rows * H * Fd)
        bounds[f"down{sfx}"] = bound_ms(Fd * H + 2 * H + 2 * rows * Fd + 2 * rows * H, 2 * rows * Fd * H)
        print(f"fused_mlp_w8 by launch (M={rows}): "
              f"{json.dumps({k: res[k] for k in res if k.startswith(('swiglu', 'down'))})}", flush=True)
        out[("mlp", rows)] = res
    small_keys += ("swiglu_ms", "down_ms", "swiglu_library_ms", "down_library_ms", "down_rel_rms")
    out["fused_mlp_w8"] = with_small("mlp", out.pop(("mlp", M)), out.pop(("mlp", m_small)), None)
    plans["down"], plans[f"down_m{m_small}"] = w8_gemm_plan(M, Fd), w8_gemm_plan(m_small, Fd)
    plans["swiglu"], plans[f"swiglu_m{m_small}"] = w8_gemm_plan(M, H), w8_gemm_plan(m_small, H)
    del w_gu, w_d, w
    torch.cuda.empty_cache()

    # the head: a table too large for L2 (389 MB), so it is cold on every launch anyway
    w_h = quant.dequantize(head)  # [V, H] bf16: the scale folded in before the dot, a yardstick only
    for rows, xr in ((M, x), (m_small, x[:m_small].contiguous())):
        tok, mx = dm.fused_head_argmax(xr, head)
        again = dm.fused_head_argmax(xr, head)
        torch.cuda.synchronize()
        if not (torch.equal(tok, again[0]) and torch.equal(mx, again[1])):
            raise AssertionError(f"fused_head_argmax (M={rows}): two launches on the same inputs differ")
        logits = dm.head_logits(xr, head)
        ref_tok = torch.argmax(logits, -1)
        top2 = torch.topk(logits, 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 1e-4 * logits.abs().amax()
        if decisive.float().mean().item() < 0.99 or not torch.equal(tok[decisive].long(), ref_tok[decisive]):
            raise AssertionError(f"fused_head_argmax: {int(decisive.sum())}/{rows} decisive rows, tokens equal on "
                                 f"{int((tok[decisive].long() == ref_tok[decisive]).sum())}")
        max_err = (mx[decisive] - top2[decisive, 0]).abs().max().item()
        del logits
        res = dict(decisive_rows=int(decisive.sum()), tokens_equal=int(decisive.sum()), max_abs_err=max_err,
                   ms=device_ms(lambda: dm.fused_head_argmax(xr, head), iters=10),
                   call_ms=cuda_ms(lambda: dm.fused_head_argmax(xr, head), iters=10),
                   plain_ms=device_ms(lambda: dm.fused_head_argmax_plain(xr, head), iters=2),
                   library_ms=device_ms(lambda: torch.mm(xr, w_h.t(), out_dtype=torch.float32).argmax(-1), iters=10))
        res["bound_ms"], res["bound_by"] = bound_ms(V * H + 2 * V + 2 * rows * H + 8 * rows, 2 * rows * H * V)
        res["shape"] = f"M={rows} fused_head_argmax x[{rows},{H}] w8[{V},{H}]"
        print(f"fused_head_argmax {json.dumps(res)}", flush=True)
        out[("head", rows)] = res
    small_keys += ("decisive_rows", "tokens_equal")
    out["fused_head_argmax"] = with_small("head", out.pop(("head", M)), out.pop(("head", m_small)), None)
    # read from the kernel's configuration or computed, not measured: never in a record
    out["plans_and_bounds"] = dict(plans=plans, bounds_ms=bounds)
    print(f"w8_gemm plans [rows, row groups, K parts, ring stages, smem bytes] and bounds: "
          f"{json.dumps(out['plans_and_bounds'])}", flush=True)
    out["digests"] = digests
    print(f"w8_gemm output fingerprints (sha256 of the bits, layer {li}): {json.dumps(digests)}", flush=True)
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


def reference_check_quant(seed: int):
    """The W8A8 and W4 modes at small width on the card against the CPU: the
    W8A8 int32 product (``quant.int8_matmul``) and W8A8 ``linear`` bit for
    bit on the same operands at 1, 8, 17 and 368 rows (Qwen3's QKV width:
    the padded products of ≤ 16 rows among them), W4 ``linear`` held to its
    CPU result by ``utils.agreement`` at 1, 8 and 17 rows, and penalised ``generate_text``
    (penalty 1.1 over the prompt, int8 cache) with W8A8 and with W4 layers:
    tokens equal on every row, or first different at a step where the CPU's
    top-2 gap is under 2e-2·max|logit| (the bf16 noise of the W8 check)."""
    import torch

    from vggt_qwen3_tpu_torch.config import Qwen3Config
    from vggt_qwen3_tpu_torch.inference import engine
    from vggt_qwen3_tpu_torch.models import qwen3
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa
    from vggt_qwen3_tpu_torch.ops import quant
    from vggt_qwen3_tpu_torch.utils.agreement import agreement

    gen = torch.Generator().manual_seed(seed)
    K, N = 2560, 4096
    w = torch.randn(K, N, generator=gen) * 0.02
    wa = quant.mark_act_quant(quant.quantize_per_channel(w))
    w4 = quant.quantize_per_group_w4(w)
    wa_card, w4_card = _to_device(wa, "cuda"), _to_device(w4, "cuda")
    for rows in (1, 8, 17, 368):
        x = (torch.randn(rows, K, generator=gen) * torch.rand(rows, 1, generator=gen) * 4).bfloat16()
        x8, _ = quant.quantize_activations(x)
        ref_i, got_i = quant.int8_matmul(x8, wa["w8"]), quant.int8_matmul(x8.cuda(), wa_card["w8"]).cpu()
        ref_y, got_y = quant.linear(x, wa), quant.linear(x.cuda(), wa_card).cpu()
        if not (torch.equal(ref_i, got_i) and torch.equal(ref_y.view(torch.int16), got_y.view(torch.int16))):
            raise AssertionError(f"W8A8 reference check: card and CPU differ at {rows} rows "
                                 f"(int32 {int((ref_i != got_i).sum())}, bf16 {int((ref_y != got_y).sum())} elements)")
        w4_note = ""
        if rows <= 17:  # W4 at decode rows (a bf16 CPU product of 368 rows takes too long here)
            held = agreement(quant.linear(x.cuda(), w4_card).float().cpu(), quant.linear(x, w4).float())
            if not held["ok"]:
                raise AssertionError(f"W4 reference check at {rows} rows: {held}")
            w4_note = f"; W4 rel RMS {held['rel_rms']:.3g}"
        print(f"reference check (W8A8 / W4 linear, [{rows}, {K}] x [{K}, {N}], card vs CPU): int32 product and W8A8 "
              f"output bit-identical{w4_note}", flush=True)

    cfg = Qwen3Config(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      intermediate_size=512)
    B, S, T = 16, 12, 8
    ids = torch.from_numpy(np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S)).astype(np.int32))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[0, :4] = 0
    gcfg = engine.GenerationConfig(max_new_tokens=T, repetition_penalty=1.1, penalize_prompt=True, kv_dtype="int8")
    for mode in ("w8a8", "w4"):
        cpu_params = qwen3.quantize_params(qwen3.init_params(torch.Generator().manual_seed(seed), cfg), mode=mode)
        (ref, _), gaps = constrained_gaps(engine, lambda: engine.generate_text(cpu_params, cfg, gcfg, input_ids=ids,
                                                                               attention_mask=mask))
        fa.launches = da.launches = 0
        got, _ = engine.generate_text(_to_device(cpu_params, "cuda"), cfg, gcfg, input_ids=ids.cuda(),
                                      attention_mask=mask.cuda())
        torch.cuda.synchronize()
        if (fa.launches, da.launches) != (cfg.num_layers, cfg.num_layers * T):
            raise AssertionError(f"{mode} reference check: launches flash {fa.launches}, decode {da.launches}")
        firsts = [(b, int(np.nonzero(got[b] != ref[b])[0][0])) for b in range(B) if (got[b] != ref[b]).any()]
        at_flip = [float(gaps[t, b]) for b, t in firsts]
        print(f"reference check ({mode}, penalised generate_text, int8 cache, card vs CPU): {B - len(firsts)}/{B} "
              f"rows token-identical; CPU top-2 gap at each first flip {[round(g, 5) for g in at_flip]}", flush=True)
        if len(firsts) == B or any(g >= 2e-2 for g in at_flip):
            raise AssertionError(f"{mode} reference check: a row flips at a decisive step, or every row differs")


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


def reference_check_slots(seed: int):
    """A small-width bf16 model (head dim 64, so the kernels run) serves
    through the slot engine with an int8 cache, on the card and on the CPU:
    four requests admitted at once, two more admitted mid-decode as slots
    free (one request's budget is 4), plain chunks and then speculative ones
    (prompt-lookup drafts from the prompt ids). A request is decisive where
    the CPU's B = 1 ``engine.generate`` gives the CPU slot engine's tokens
    and its top-2 gap exceeds 1e-4·max|logit| at every step; every decisive
    request must give the same tokens on the card, and one must exist. The
    card's runs must launch the decode-attention (plain chunks) and
    block-verify (speculative) kernels."""
    import torch

    from vggt_qwen3_tpu_torch.config import Qwen3Config
    from vggt_qwen3_tpu_torch.inference import engine
    from vggt_qwen3_tpu_torch.inference.slots import SlotEngine
    from vggt_qwen3_tpu_torch.models import qwen3
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    cfg = Qwen3Config(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      intermediate_size=512)
    cpu_params = qwen3.init_params(torch.Generator().manual_seed(seed + 2), cfg)
    R, S, N = 6, 24, 24
    rng = np.random.default_rng(seed + 2)
    ids = rng.integers(1, 256, (R, S)).astype(np.int32)
    mask = np.ones((R, S), np.int32)
    for r in range(R):  # left pads of 0..5
        mask[r, :r] = 0
        ids[r, :r] = 0
    budgets = [None, 4, None, None, None, 12]
    gcfg = engine.GenerationConfig(max_new_tokens=N, pad_token_id=0, repetition_penalty=1.1, kv_dtype="int8")

    def serve(dev, params, spec):
        eng = SlotEngine(params, cfg, gcfg, num_slots=4, max_len=S + N, decode_chunk=4, speculative=spec,
                         draft_k=DRAFT_K, spec_chunk=2, spec_min_gain=0.5)
        with torch.inference_mode():
            emb = [qwen3.embed_tokens(params, torch.from_numpy(ids[r:r + 1]).to(dev)) for r in range(R)]

        def submit(r):
            return eng.submit_embeds(emb[r], torch.from_numpy(mask[r:r + 1]), max_new_tokens=budgets[r],
                                     lookup_ids=torch.from_numpy(ids[r:r + 1]) if spec else None)

        futs = [submit(r) for r in range(4)]
        eng.step_once()
        futs += [submit(r) for r in range(4, R)]
        eng.run_until_idle()
        return [f.result(timeout=0) for f in futs], eng.stats

    cpu = {spec: serve(torch.device("cpu"), cpu_params, spec)[0] for spec in (False, True)}
    refs = []
    for r in range(R):
        with torch.inference_mode():
            (toks, _), gaps = constrained_gaps(engine, lambda: engine.generate(
                cpu_params, cfg, gcfg, inputs_embeds=qwen3.embed_tokens(cpu_params, torch.from_numpy(ids[r:r + 1])),
                attention_mask=torch.from_numpy(mask[r:r + 1])))
        refs.append((toks[0], gaps[:, 0]))
    gpu_params = _to_device(cpu_params, "cuda")
    fa.launches, da.launches, da.verify_launches = 0, 0, 0
    card_plain, stats_plain = serve(torch.device("cuda"), gpu_params, False)
    launched_plain = (fa.launches, da.launches, da.verify_launches)
    da.launches, da.verify_launches = 0, 0
    card_spec, stats_spec = serve(torch.device("cuda"), gpu_params, True)
    launched_spec = (da.launches, da.verify_launches)
    torch.cuda.synchronize()
    report = {}
    for name, card, cpu_run in (("plain", card_plain, cpu[False]), ("speculative", card_spec, cpu[True])):
        decisive = [len(cpu_run[r][0]) > 0 and np.array_equal(cpu_run[r][0], refs[r][0][:cpu_run[r][1]])
                    and refs[r][1][:cpu_run[r][1]].min() > 1e-4 for r in range(R)]
        same = [np.array_equal(card[r][0], cpu_run[r][0]) for r in range(R)]
        report[name] = (int(sum(decisive)), int(sum(d and s for d, s in zip(decisive, same))), int(sum(same)))
        if not any(decisive) or not all(s for d, s in zip(decisive, same) if d):
            raise AssertionError(f"slot reference check ({name}): card and CPU differ on a decisive request, "
                                 f"or none is: decisive {decisive}, identical {same}")
    print(f"reference check (small width, slot engine, int8 cache, card vs CPU, {R} requests, 4 slots): "
          f"(decisive, decisive and identical, identical) plain {report['plain']}, speculative "
          f"{report['speculative']}; card admissions {stats_plain.admit_dispatches} dispatches, "
          f"{stats_plain.admitted_mid_decode} mid-decode; launches (flash, decode, verify) plain {launched_plain}, "
          f"speculative (decode, verify) {launched_spec}", flush=True)
    if not (launched_plain[0] > 0 and launched_plain[1] > 0 and launched_spec[1] > 0
            and stats_plain.admitted_mid_decode >= 1 and stats_spec.spec_blocks > 0):
        raise AssertionError(f"slot reference check: kernels not launched or no mid-decode admission "
                             f"({launched_plain}, {launched_spec}, {stats_plain}, {stats_spec})")


def _fingerprint(t):
    """An exact fingerprint of a tensor's bits: (sum, sum of squares) of its
    16-bit words (of its bytes, for a 1-byte type) as int64 — any update of
    an element changes it."""
    import torch

    t = local(t)
    w = t.detach().contiguous().view(torch.uint8 if t.element_size() == 1 else torch.int16).to(torch.int64)
    return int(w.sum()), int((w * w).sum())


def local(t):
    """A DTensor's local tensor (on a 1-rank mesh, the whole); anything else as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


@contextlib.contextmanager
def one_rank_mesh():
    """``build_mesh(None)`` on a world of this process alone (NCCL, no
    address), destroyed on exit."""
    from vggt_qwen3_tpu_torch.ops.ring_attention import single_rank_group
    from vggt_qwen3_tpu_torch.parallel.mesh import build_mesh

    with single_rank_group("cuda"):
        yield build_mesh(None, "cuda")


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
    back. Then the same micro steps through the meshed step of a 1-rank NCCL
    world (bit for bit the unmeshed card run), whose train state is saved
    (``checkpoint.save``: the shards of each rank, here the one) and restored
    onto the mesh (``checkpoint.restore(mesh=...)``): every parameter and
    optimizer leaf and the counters bit for bit the saved ones, and the next
    two micro steps give the live run's losses exactly and its update to
    1e-3."""
    import shutil

    import torch
    from torch.distributed.tensor import DTensor

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
    meshed_params = _to_device(cpu.params, "cuda")
    card_tx = trainer.make_tx(st, card_params)
    card = trainer.TrainState(params=card_params, opt_state=card_tx.init(card_params), step=0)
    init = {n: t.clone() for n, t in trainer.named_leaves(cpu.params)}

    def run(state, tx, dev, steps, sharding=None):
        grads, metrics = {}, []
        real = tx.update

        def capture(g, opt_state, params):
            if not grads:
                grads.update({n: local(t).float().cpu() for n, t in g.items()
                              if n.startswith("vision/") and t is not None})
            return real(g, opt_state, params)

        tx.update = capture
        try:
            step = trainer.make_train_step(st, tx, img_id, has_geom=True, state_sharding=sharding)
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

    # the same micro steps on a 1-rank NCCL mesh: every gather and reduction is the identity
    with one_rank_mesh() as mesh:
        tx = trainer.make_tx(st, meshed_params)
        meshed = trainer.TrainState(params=meshed_params, opt_state=tx.init(meshed_params), step=0)
        sharding = trainer.state_shardings(meshed, mesh)
        n0 = (fa.launches, fa.dq_launches, fa.dkv_launches)
        meshed, meshed_g, meshed_m = run(meshed, tx, "cuda", range(4), sharding)
        torch.cuda.synchronize()
        meshed_launches = (fa.launches - n0[0], fa.dq_launches - n0[1], fa.dkv_launches - n0[2])
        placed = sum(isinstance(p, DTensor) for _, p in trainer.named_leaves(meshed.params))
        differ = [n for (n, a), (_, b) in zip(trainer.named_leaves(meshed.params), trainer.named_leaves(card.params))
                  if not torch.equal(local(a), b)]
        differ += [f"gradient {n}" for n in card_g if not torch.equal(meshed_g[n], card_g[n])]
        print(f"training reference check, meshed (1-rank NCCL world, {placed} DTensor leaves): losses/grad norms "
              f"{meshed_m == card_m}, {len(differ)} leaves or gradients differ from the unmeshed card run; launches "
              f"{meshed_launches}", flush=True)
        if meshed_m != card_m or differ or meshed_launches != card_launches or placed == 0:
            raise AssertionError(f"training reference check: the 1-rank meshed step is not the unmeshed one bit for "
                                 f"bit ({meshed_m} vs {card_m}; {differ[:5]})")

        # the meshed state saved and restored onto the mesh, and the same next two micro steps
        out = REPO / "ckpts" / "chip_smoke_train"
        shutil.rmtree(out, ignore_errors=True)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ckpt.save(meshed, out / "step_4")
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            restored = ckpt.restore(ckpt.latest_step_dir(out), "cuda", mesh=mesh)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t
            files = sorted(p.name for p in (out / "step_4").iterdir())
            leaves = lambda st_: dict(trainer.named_leaves({"params": st_.params, **{  # noqa: E731
                k: st_.opt_state[k] for k in ("mu", "nu", "acc")}}))
            saved, back = leaves(meshed), leaves(restored)
            differ = [n for n in saved if n not in back or type(back[n]) is not type(saved[n])
                      or not torch.equal(local(saved[n]), local(back[n]))]
            if list(saved) != list(back) or differ:
                raise AssertionError(f"restore: {len(differ)} leaves differ ({differ[:5]})")
            if (restored.step, restored.opt_state["gradient_step"], restored.opt_state["mini_step"]) != \
                    (meshed.step, meshed.opt_state["gradient_step"], meshed.opt_state["mini_step"]):
                raise AssertionError("restore: counters differ")
            before = {n: local(t).float().clone() for n, t in trainer.named_leaves(meshed.params)}
            live, _, live_m = run(meshed, tx, "cuda", range(4, 6), sharding)
            again, _, again_m = run(restored, trainer.make_tx(st, restored.params), "cuda", range(4, 6),
                                    trainer.state_shardings(restored, mesh))
        finally:
            shutil.rmtree(out, ignore_errors=True)
    num = den = 0.0
    for (n, a), (_, b) in zip(trainer.named_leaves(live.params), trainer.named_leaves(again.params)):
        num += (local(a).float() - local(b).float()).norm().item() ** 2
        den += (local(a).float() - before[n]).norm().item() ** 2
    rel = (num / max(den, 1e-30)) ** 0.5
    print(f"training restore check (1-rank NCCL world): saved in {save_s:.3f} s ({', '.join(files)}), restored onto "
          f"the mesh in {restore_s:.3f} s, {len(saved)} leaves bit for bit; next losses live {live_m} restored "
          f"{again_m}; updates rel {rel:.3e}", flush=True)
    if [m[0] for m in live_m] != [m[0] for m in again_m] or not rel <= 1e-3 or den == 0.0:
        raise AssertionError("restore: the restored state does not give the live run's next steps")


def train_path(args):
    """The full-width SFT path on the card: the stage of configs/stage1_3d.yaml
    (train_stage) through the trainer's entry points (init_train_state,
    sft.build_data over the ScanQA/SQA3D placeholder records with seeded
    views, make_train_step, step_generator): (a) the recipe as shipped, the
    tower frozen, 2 micro steps; (b) freeze_vision false, 4 micro steps (2
    updates). Launch counters are set to 0 just before and read just after
    each micro step and each run. Each run's state is laid out on a 1-rank
    NCCL mesh (``state_shardings`` on ``build_mesh(None)``) and its steps
    run through ``make_train_step(state_sharding=...)``. Then the sft CLI
    once (``sft_cli_check``). Returns (b)'s per-run counts and numbers."""
    import gc

    import torch

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer

    tok = load_tokenizer(None)
    img_id = tok.convert_tokens_to_ids("<image>")
    base = train_stage()
    vc = base.model.vision
    blocks = vc.patch_depth + 2 * vc.num_layers  # 72 attentions a forward
    result = {}
    parts = Parts()
    for frozen, n_micro in ((True, 2), (False, 2 * TRAIN_GRAD_ACCUM)):
        with one_rank_mesh() as mesh:
            train_run(args, base, frozen, n_micro, mesh, tok, img_id, blocks, result)
        parts.mark("tower frozen" if frozen else "tower trained, with its profile")
    gc.collect()
    torch.cuda.empty_cache()
    sft_cli_check(args)
    parts.mark("sft CLI")
    parts.report("training path")
    return result


def train_run(args, base, frozen: bool, n_micro: int, mesh, tok, img_id: int, blocks: int, result: dict):
    """One run of ``train_path`` on ``mesh``; (b)'s numbers go into ``result``."""
    import dataclasses
    import gc

    import torch

    from vggt_qwen3_tpu_torch.ops import flash_attention as fa
    from vggt_qwen3_tpu_torch.train import sft, trainer

    st = dataclasses.replace(base, model=dataclasses.replace(base.model, freeze_vision=frozen))
    what = "recipe as shipped (tower frozen)" if frozen else "freeze_vision false"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state, tx = trainer.init_train_state(torch.Generator(device="cuda").manual_seed(args.seed), st,
                                         dtype=st.model.dtype, mesh=mesh)
    shardings = trainer.state_shardings(state, mesh)
    torch.cuda.synchronize()
    leaves = {n: local(p) for n, p in trainer.named_leaves(state.params)}
    n_params = sum(p.numel() for p in leaves.values())
    n_train = sum(p.numel() for n, p in leaves.items() if tx.labels[n] != "frozen")
    print(f"training ({what}): random init of {n_params / 1e9:.3f} B params ({n_train / 1e9:.3f} B trainable) "
          f"in {time.perf_counter() - t:.1f} s, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    prints = {n: _fingerprint(p) for n, p in leaves.items()}
    lora_frozen = {n: [_fingerprint(p[i]) for i in st.freeze_text_layers]
                   for n, p in leaves.items() if n.startswith("text/layers/lora/")}
    min_abs = {n: p.abs().min().item() for n, p in leaves.items() if tx.labels[n] != "frozen"}
    loader = sft.build_data(st, tok, datasets=seeded_datasets(st, args.seed))
    step_fn = trainer.make_train_step(st, tx, img_id, has_geom=True, state_sharding=shardings)
    walls, per_step, metrics, tokens = [], [], [], []
    run_counts = dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0)
    for s in range(n_micro):
        batch = sft.to_device(next(loader), "cuda")
        gen = trainer.step_generator(st.train.seed + 1, s, "cuda")
        torch.cuda.synchronize()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        fa.fwd_copies.update(dict.fromkeys(fa.fwd_copies, 0))
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
    if any(fa.fwd_copies.values()):  # of the last micro step
        raise AssertionError(f"training ({what}): the flash forward copied operands {fa.fwd_copies}")
    if not all(np.isfinite(x) for m in metrics for x in m):
        raise AssertionError(f"training ({what}): loss or grad_norm not finite: {metrics}")
    if state.opt_state["gradient_step"] != n_micro // TRAIN_GRAD_ACCUM:
        raise AssertionError(f"training ({what}): {state.opt_state['gradient_step']} updates")
    leaves = {n: local(p) for n, p in trainer.named_leaves(state.params)}
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
        no_grad = [n for n in still if not local(state.opt_state["mu"][n]).any()]
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
        # one more update's pair of micro steps: the second, which runs the optimizer, under the profiler,
        # tracing the device only with the update between two marker kernels; one session (in the whole
        # script every session of this step missed one of its 144 flash forwards: more sessions repeat it)
        state, _ = step_fn(state, sft.to_device(next(loader), "cuda"),
                           trainer.step_generator(st.train.seed + 1, n_micro, "cuda"))
        batch = sft.to_device(next(loader), "cuda")
        gen = trainer.step_generator(st.train.seed + 1, n_micro + 1, "cuda")
        update = tx.update

        def marked_update(*a):
            torch.cuda._sleep(MARK_CYCLES)
            out = update(*a)
            torch.cuda._sleep(MARK_CYCLES)
            return out

        tx.update = marked_update
        try:
            profile_breakdown("training micro step (freeze_vision false, with the update)",
                              lambda: step_fn(state, batch, gen), unprofiled_s=mean, tries=1,
                              marked_range=("optimizer", 2))
        finally:
            tx.update = update
    del state, tx, leaves, loader, step_fn
    gc.collect()
    torch.cuda.empty_cache()


def sft_cli_check(args):
    """One call of the sft CLI on the card — ``--fsdp 1 --tiny --mock_vision
    --max_steps 2`` on ``configs/stage1_3d.yaml`` — for its mesh wiring on
    NCCL: the mesh line printed, two finite losses logged, the final
    checkpoint written (``train/checkpoint.py``'s format) and read back whole
    by this process with no process group (what inference loads), and no
    process group left behind."""
    import shutil

    import torch
    import torch.distributed as dist

    from vggt_qwen3_tpu_torch.train import checkpoint as ckpt
    from vggt_qwen3_tpu_torch.train import sft

    out = REPO / "ckpts" / "chip_smoke_sft"
    shutil.rmtree(out, ignore_errors=True)
    t = time.perf_counter()
    try:
        sft.main(["--config", str(REPO / "configs" / "stage1_3d.yaml"), "--output_dir", str(out), "--data_root",
                  str(REPO), "--fsdp", "1", "--tiny", "--mock_vision", "--max_steps", "2", "--log_every_steps", "1",
                  "--seed", str(args.seed), "--device", "cuda"])
        losses = [json.loads(x)["loss"] for x in (out / "metrics.jsonl").read_text().splitlines()]
        saved = ckpt.is_step_dir(out / "step_2") and all(
            torch.isfinite(t.float()).all() for t in _leaves(ckpt.load_params(out / "step_2", "cuda")))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(f"sft CLI (--fsdp 1 --tiny --mock_vision, 2 steps on a 1-rank NCCL world): losses {losses}, checkpoint "
          f"written {saved}, {time.perf_counter() - t:.1f} s", flush=True)
    if len(losses) != 2 or not all(np.isfinite(losses)) or not saved or dist.is_initialized():
        raise AssertionError("sft CLI: the run did not log two finite losses and save its checkpoint")


RECIPE_CYCLE = 2  # micro steps in the recipe phase's timed cycle (the recipe accumulates 32)
RECIPE_MICRO_REPS, RECIPE_CYCLE_REPS = 2, 1  # timed micro steps and cycles after their warm-ups (the bench's 3, 2)
RECIPE_MAX_STEPS = 4  # its schedule horizon (30,000): the second update runs at the peak learning rate
STAGE2_BATCH, STAGE2_GRAD_ACCUM = 2, 2  # the stage-2 run (the recipe: 4 rows, grad_accum 64)
MARK_CYCLES = 100  # a torch.cuda._sleep marker kernel on either side of each optimizer update in a profile


def recipe_stage():
    """The stage ``configs/stage1_3d.yaml`` gives the trainer (LoRA r16 on
    qkvo, text layers 0-3 frozen, B 6, grad_accum 32), built from the
    presets, with one reduction for the recipe phase: a schedule horizon of
    ``RECIPE_MAX_STEPS`` updates (30,000), so that the bench's second update
    runs at the peak learning rate."""
    import dataclasses

    st = train_stage()
    return dataclasses.replace(st, train=dataclasses.replace(st.train, batch_size_per_device=6, grad_accum=32,
                                                             max_steps=RECIPE_MAX_STEPS))


def stage2_train_stage():
    """The stage ``configs/stage2_arkit.yaml`` gives the trainer (LoRA r32 on
    q/v/o, text layers 0-1 frozen, 10 views, max_length 4096, view dropout
    0.2), built from the presets, reduced for the chip check: 2 rows a micro
    step (the recipe has 4) and grad_accum 2 (64)."""
    import dataclasses

    from vggt_qwen3_tpu_torch.config import LoRAConfig, TrainConfig

    return dataclasses.replace(
        arkit_stage(),
        train=TrainConfig(precision="bf16", optimizer="adamw", lr=2e-5, proj_lr=2e-4, weight_decay=0.05,
                          warmup_ratio=0.05, batch_size_per_device=STAGE2_BATCH, grad_accum=STAGE2_GRAD_ACCUM,
                          max_steps=10_000, save_every_steps=1000, eval_every_steps=2000, log_every_steps=20,
                          gradient_clip=1.0, seed=42),
        lora=LoRAConfig(enable=True, rank=32, alpha=64, dropout=0.05, target_modules=("q_proj", "v_proj", "o_proj")),
        freeze_text_layers=(0, 1),
    )


def reference_check_adam8bit(seed: int):
    """The 8-bit AdamW update at small width, card against CPU: (1) the same
    seeded f32 gradients through ``trainer.Optimizer(optimizer="adamw8bit")``
    over the small stage's tree, 2 updates at grad_accum 2: the int8 codes
    may differ by one where the two devices round an f32 intermediate
    differently, and the count of such codes is printed and held to 1e-4 of
    all; the scales and the parameters to 1e-6 relative; (2) the small-width
    bf16 trainer run (``_small_train_stage`` with ``adamw8bit``, the tower
    frozen) on both devices from the same weights and batches, 4 micro steps:
    losses within 1e-2 and grad norms within 2e-2 relative, the loss of the
    first batch under the updated parameters within 1e-2, frozen leaves
    unmoved. The parameter updates and the moments' codes of that run are
    printed, not held: the bf16 gradients differ at bf16's resolution, and
    the JAX algorithm's linear ``nu`` codes (ROADMAP §3) turn an element
    whose gradient falls between updates into a step of the gradients'
    ratio, so the two runs' updates differ at their own size (measured:
    ‖Δcard − Δcpu‖₂ = 1.26·‖Δcpu‖₂, single elements moving by up to 10 at a
    learning rate of 1e-3 on both devices). Returns the measured numbers."""
    import dataclasses

    import torch

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.models import vlm
    from vggt_qwen3_tpu_torch.train import sft, trainer

    st = _small_train_stage()
    st = dataclasses.replace(st, model=dataclasses.replace(st.model, freeze_vision=True),
                             train=dataclasses.replace(st.train, optimizer="adamw8bit"))
    out = {}
    # (1) the same gradients on both devices
    cpu_params, _ = trainer.init_train_state(torch.Generator().manual_seed(seed), st, dtype="float32")
    card_params = _to_device(cpu_params.params, "cuda")
    cpu_params = cpu_params.params
    txs = {d: trainer.make_tx(st, p) for d, p in (("host", cpu_params), ("card", card_params))}
    states = {d: txs[d].init(p) for d, p in (("host", cpu_params), ("card", card_params))}
    rng = np.random.default_rng(seed)
    for _ in range(4):
        g = {n: torch.from_numpy((rng.standard_normal(p.shape) * 0.05).astype(np.float32))
             for n, p in trainer.named_leaves(cpu_params)}
        txs["host"].update(g, states["host"], cpu_params)
        txs["card"].update({n: t.cuda() for n, t in g.items()}, states["card"], card_params)
    torch.cuda.synchronize()
    off = total = 0
    worst_code = 0
    for key in ("mu", "nu"):
        for n, m in states["host"][key].items():
            d = (states["card"][key][n]["q"].cpu().int() - m["q"].int()).abs()
            worst_code = max(worst_code, int(d.max()))
            off += int((d != 0).sum())
            total += d.numel()
            s_rel = ((states["card"][key][n]["s"].cpu() - m["s"]).abs() / m["s"].abs().clamp_min(1e-30)).max().item()
            if s_rel > 1e-6 and not (m["s"] == 0).all():
                raise AssertionError(f"8-bit update card vs CPU: scales of {key}/{n} {s_rel:.3e} apart")
    cpu_leaves = dict(trainer.named_leaves(cpu_params))
    p_rel = max(((p.cpu() - cpu_leaves[n]).abs() / cpu_leaves[n].abs().clamp_min(1e-30)).max().item()
                for n, p in trainer.named_leaves(card_params))
    identical = all(torch.equal(p.cpu(), cpu_leaves[n]) for n, p in trainer.named_leaves(card_params))
    out.update(same_grads_codes_off_by_one=off, same_grads_codes=total, same_grads_worst_code=worst_code,
               same_grads_params_rel=p_rel, same_grads_params_identical=identical)
    print(f"8-bit AdamW card vs CPU, the same f32 gradients, 2 updates: {off} of {total} int8 codes differ "
          f"(at most by {worst_code}); parameters {'bit-identical' if identical else f'within {p_rel:.3e} relative'}",
          flush=True)
    if worst_code > 1 or off > 1e-4 * total or p_rel > 1e-6:
        raise AssertionError("8-bit update card vs CPU: the same gradients give other updates")
    # (2) the bf16 trainer run on both devices
    tok = load_tokenizer(None)
    img_id = tok.convert_tokens_to_ids("<image>")
    loader = sft.build_data(st, tok, datasets=seeded_datasets(st, seed))
    batches = [next(loader) for _ in range(4)]
    cpu, cpu_tx = trainer.init_train_state(torch.Generator().manual_seed(seed), st, dtype="bfloat16")
    init = {n: t.clone() for n, t in trainer.named_leaves(cpu.params)}
    card_params = _to_device(cpu.params, "cuda")
    card_tx = trainer.make_tx(st, card_params)
    card = trainer.TrainState(params=card_params, opt_state=card_tx.init(card_params), step=0)
    metrics = {}
    for name, state, tx, dev in (("card", card, card_tx, "cuda"), ("host", cpu, cpu_tx, "cpu")):
        step = trainer.make_train_step(st, tx, img_id, has_geom=True)
        metrics[name] = []
        for b in batches:
            state, m = step(state, sft.to_device(b, dev), None)
            metrics[name].append((float(m["loss"]), float(m["grad_norm"])))
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(metrics["card"], metrics["host"]))
    norm_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(metrics["card"], metrics["host"]))
    after = {}  # the loss of the first batch under the updated parameters
    for name, state, dev in (("card", card, "cuda"), ("host", cpu, "cpu")):
        b = sft.to_device(batches[0], dev)
        with torch.no_grad():
            after[name] = float(vlm.train_forward(state.params, st.model, images=b["pixel_values"],
                                                  geom_token=b["geom_token"], input_ids=b["input_ids"],
                                                  attention_mask=b["attention_mask"], labels=b["labels"],
                                                  image_token_id=img_id))
    after_rel = abs(after["card"] - after["host"]) / abs(after["host"])
    num = den = 0.0
    per_leaf = {}
    cpu_leaves = dict(trainer.named_leaves(cpu.params))
    for n, p in trainer.named_leaves(card.params):
        if card_tx.labels[n] == "frozen":
            if not torch.equal(p.cpu(), init[n]):
                raise AssertionError(f"8-bit trainer card vs CPU: frozen leaf {n} changed on the card")
            continue
        got, ref, p0 = p.float().cpu(), cpu_leaves[n].float(), init[n].float()
        d, r = ((got - p0) - (ref - p0)).norm().item(), (ref - p0).norm().item()
        per_leaf[n] = (d / max(r, 1e-30), r, (got - p0).abs().max().item(), (ref - p0).abs().max().item())
        num += d ** 2
        den += r ** 2
    upd_rel = (num / max(den, 1e-30)) ** 0.5
    worst = sorted(per_leaf.items(), key=lambda kv: -kv[1][0])[:6]
    print("8-bit AdamW trainer card vs CPU: the leaves whose updates differ most (rel, ‖Δcpu‖₂, max|Δcard|, "
          f"max|Δcpu|): {[(n, [float(f'{x:.3e}') for x in v]) for n, v in worst]}", flush=True)
    codes = []
    for key in ("mu", "nu"):
        for n, m in cpu.opt_state[key].items():
            codes.append((card.opt_state[key][n]["q"].cpu().int() - m["q"].int()).abs())
    codes = torch.cat([c.reshape(-1) for c in codes])
    out.update(loss_rel=loss_rel, grad_norm_rel=norm_rel, loss_after_rel=after_rel, updates_rel=upd_rel,
               codes_differ=int((codes != 0).sum()), codes_differ_by_one=int((codes == 1).sum()),
               codes_worst=int(codes.max()), codes=codes.numel())
    print(f"8-bit AdamW trainer card vs CPU (small width, bf16, tower frozen, 4 micro steps, 2 updates): loss rel "
          f"{loss_rel:.3e}, grad_norm rel {norm_rel:.3e}, loss after the updates {after} (rel {after_rel:.3e}), "
          f"updates rel {upd_rel:.3e} (not held); int8 codes differing "
          f"{out['codes_differ']} of {out['codes']} ({out['codes_differ_by_one']} by one, at most "
          f"{out['codes_worst']}); losses card {[round(m[0], 5) for m in metrics['card']]} CPU "
          f"{[round(m[0], 5) for m in metrics['host']]}", flush=True)
    if not (loss_rel <= 1e-2 and norm_rel <= 2e-2 and after_rel <= 1e-2 and den > 0):
        raise AssertionError("8-bit trainer card vs CPU: card and CPU disagree")
    return out


def stage2_flash_check(gen) -> dict:
    """Kernel 1 at the stage-2 training run's VGGT global attention, [2,
    10·1029, 16, 64] (``check_flash``)."""
    st = stage2_train_stage()
    vc = st.model.vision
    tpf = vc.patch_start_idx + (st.data.image_size // vc.patch_size) ** 2
    return check_flash("stage2_global", STAGE2_BATCH, st.data.num_views * tpf, st.data.num_views * tpf, vc.num_heads,
                       vc.num_heads, vc.embed_dim // vc.num_heads, causal=False, starts=[0] * STAGE2_BATCH, gen=gen)


def train_recipes_path(args):
    """The phase "training recipes": (a) the bench's train mode at the
    stage-1 recipe's micro batch (``recipe_stage``: B 6, 8 views at 448²,
    text 512, the W8A8 tower, the W8 base plus LoRA, 8-bit AdamW, full width
    and depth, a cycle of ``RECIPE_CYCLE`` micro steps) with its launches
    (72 flash forwards a micro step, nothing else), frozen leaves unmoved and
    trainable ones moved, and a device-only profile of one cycle; (b) the
    stage of ``configs/stage2_arkit.yaml`` (``stage2_train_stage``) through
    ``init_train_state``, ``sft.build_data`` over the ARKit placeholder split
    (its records and JPEGs read by the port's readers) and
    ``make_train_step``: 2 micro steps, one update; (c)
    ``reference_check_adam8bit``."""
    import gc

    import torch

    from vggt_qwen3_tpu_torch import bench
    from vggt_qwen3_tpu_torch.data import image_decode, jsonl_index
    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa
    from vggt_qwen3_tpu_torch.train import sft, trainer

    out = {}
    # (a) the bench's train mode at the recipe's micro batch
    st = recipe_stage()
    vc = st.model.vision
    blocks = vc.patch_depth + 2 * vc.num_layers  # 72 attentions a forward
    bargs = bench.parse_args(["--mode", "train", "--cycle", str(RECIPE_CYCLE), "--seed", str(args.seed),
                              "--device", "cuda"])
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    s = bench.train_setup(bargs, stage=st)
    torch.cuda.synchronize()
    leaves = dict(trainer.named_leaves(s.params))
    prints = {n: _fingerprint(p) for n, p in leaves.items()}
    lora_frozen = {n: [_fingerprint(p[i]) for i in st.freeze_text_layers]
                   for n, p in s.trainable.items() if n.startswith("text/layers/lora/")}
    min_abs = {n: p.abs().min().item() for n, p in s.trainable.items()}
    print(f"training recipes (a) bench train mode: setup {time.perf_counter() - t:.1f} s, "
          f"{s.B} rows x {s.V} views x {s.S}^2, text {s.T}, vision {bargs.vquant}, frozen text {bargs.textq}, "
          f"{bargs.opt}, {sum(p.numel() for p in s.trainable.values()) / 1e9:.3f} B trainable; memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    _zero_counters()
    loss, grads = bench.train_micro(s, 0)
    torch.cuda.synchronize()
    per_micro = _counters()
    grad_norm = float(trainer.global_norm(grads.values()))
    del grads
    _zero_counters()
    res = bench.train_measure(s, micro_reps=RECIPE_MICRO_REPS, cycle_reps=RECIPE_CYCLE_REPS)
    torch.cuda.synchronize()
    run_counts = _counters()
    n_micro = 1 + RECIPE_MICRO_REPS + (1 + RECIPE_CYCLE_REPS) * s.k
    want = {k: (blocks if k == "flash_fwd" else 0) for k in per_micro}
    print(f"training recipes (a): micro step {res['micro_s']:.4f} s (walls {res['micro_walls_s']}), cycle of {s.k} "
          f"micro steps + the {bargs.opt} update {res['cycle_s']:.4f} s (walls {res['cycle_walls_s']}), update "
          f"residual {res['update_residual_s']:.4f} s, recipe step (accum {s.accum}) {res['step_s']:.3f} s, "
          f"{res['tok_s']:.1f} text tokens/s, MFU {100 * res['mfu']:.2f}% ({res['mfu_peak']}; "
          f"{res['flops_micro'] / 1e12:.1f} TFLOP a micro step), peak memory {res['peak_gib']:.2f} GiB; loss "
          f"{float(loss):.4f}, grad_norm {grad_norm:.4f}; losses {res['losses']}; launches a micro step "
          f"{json.dumps(per_micro)}, in the run of {n_micro} micro steps {json.dumps(run_counts)}", flush=True)
    if per_micro != want or run_counts != {k: n_micro * v for k, v in want.items()}:
        raise AssertionError(f"training recipes (a): launches {per_micro} a micro step, {run_counts} in the run; "
                             f"expected {want} a micro step")
    if not (np.isfinite(float(loss)) and np.isfinite(grad_norm)):
        raise AssertionError(f"training recipes (a): loss {float(loss)} or grad_norm {grad_norm} not finite")
    if s.opt_state["gradient_step"] != 1 + RECIPE_CYCLE_REPS:
        raise AssertionError(f"training recipes (a): {s.opt_state['gradient_step']} updates")
    leaves = dict(trainer.named_leaves(s.params))
    moved = [n for n in s.trainable if _fingerprint(leaves[n]) != prints[n]]
    for n, p in leaves.items():
        if n not in s.trainable and _fingerprint(p) != prints[n]:
            raise AssertionError(f"training recipes (a): frozen leaf {n} changed")
    for n, fps in lora_frozen.items():
        if [_fingerprint(leaves[n][i]) for i in st.freeze_text_layers] != fps:
            raise AssertionError(f"training recipes (a): the adapters of a frozen layer changed ({n})")
    # a trainable leaf may stay unchanged only where no gradient reached it (its 8-bit mu codes all 0)
    # or every element's step is under half a bf16 ulp (|p| > 768·lr everywhere)
    lr = {"base": st.train.lr, "proj": st.train.proj_lr}
    still = [n for n in s.trainable if n not in moved]
    no_grad = [n for n in still if not s.opt_state["mu"][n]["q"].any()]
    bad = [n for n in still if n not in no_grad and min_abs[n] <= 768 * lr[s.tx.labels[n]]]
    print(f"training recipes (a): {len(moved)} of {len(s.trainable)} trainable leaves changed; unchanged with no "
          f"gradient yet: {no_grad}; unchanged, every element's step under half a bf16 ulp: "
          f"{[n for n in still if n not in no_grad]}", flush=True)
    if bad:
        raise AssertionError(f"training recipes (a): trainable leaves unchanged after the updates: {bad}")

    def marked_cycle():
        for i in range(s.k):
            _, g = bench.train_micro(s, 900 + i)
            torch.cuda._sleep(MARK_CYCLES)
            s.tx.update(g, s.opt_state, s.params)
            torch.cuda._sleep(MARK_CYCLES)
            del g

    profile_breakdown(f"training recipes (a): one cycle ({s.k} micro steps + the {bargs.opt} update)", marked_cycle,
                      unprofiled_s=res["cycle_s"], marked_range=("optimizer", 2 * s.k))
    out["recipe"] = dict(res, per_micro=per_micro, counts=run_counts, loss=float(loss), grad_norm=grad_norm)
    del s, leaves, prints
    gc.collect()
    torch.cuda.empty_cache()

    # (b) stage 2 through the trainer on the ARKit placeholder split
    st = stage2_train_stage()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tok = load_tokenizer(None)
    img_id = tok.convert_tokens_to_ids("<image>")
    t = time.perf_counter()
    state, tx = trainer.init_train_state(torch.Generator(device="cuda").manual_seed(args.seed), st,
                                         dtype=st.model.dtype)
    torch.cuda.synchronize()
    leaves = dict(trainer.named_leaves(state.params))
    prints = {n: _fingerprint(p) for n, p in leaves.items() if tx.labels[n] == "frozen"}
    lora_frozen = {n: [_fingerprint(p[i]) for i in st.freeze_text_layers]
                   for n, p in leaves.items() if n.startswith("text/layers/lora/")}
    print(f"training recipes (b) stage 2: random init in {time.perf_counter() - t:.1f} s, LoRA on "
          f"{sorted(state.params['text']['layers']['lora'])}, memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    decoded0 = dict(image_decode.decoded)
    t = time.perf_counter()
    loader = sft.build_data(st, tok, data_root=str(REPO))
    batches = [next(loader) for _ in range(STAGE2_GRAD_ACCUM)]
    read_s = time.perf_counter() - t
    decoded = {k: v - decoded0[k] for k, v in image_decode.decoded.items()}
    native_ok = image_decode.native_available()
    print(f"training recipes (b): read {len(batches)} batches of {STAGE2_BATCH} ARKit records "
          f"({json.dumps(st.data.datasets)}) in "
          f"{read_s:.2f} s; images decoded: {json.dumps(decoded)} (native decoder "
          f"{'available' if native_ok else 'not available: ' + str(image_decode.why_not_native())}"
          f"; JSONL index native: {jsonl_index.native_available()})", flush=True)
    if sum(decoded.values()) == 0:
        raise AssertionError("training recipes (b): no image was decoded")
    step_fn = trainer.make_train_step(st, tx, img_id, has_geom=True)
    walls, per_step, metrics = [], [], []
    stage2_counts = dict.fromkeys(_counters(), 0)
    for i, b in enumerate(batches):
        b = sft.to_device(b, "cuda")
        if b["pixel_values"].shape[1:] != (st.data.num_views, 3, st.data.image_size, st.data.image_size) or \
                b["input_ids"].shape[1] != st.data.max_length:
            raise AssertionError(f"training recipes (b): batch shapes {tuple(b['pixel_values'].shape)}, "
                                 f"{tuple(b['input_ids'].shape)}")
        gen_i = trainer.step_generator(st.train.seed + 1, i, "cuda")
        torch.cuda.synchronize()
        _zero_counters()
        fa.fwd_copies.update(dict.fromkeys(fa.fwd_copies, 0))
        t = time.perf_counter()
        state, m = step_fn(state, b, gen_i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        c = _counters()
        per_step.append(c)
        for k in stage2_counts:
            stage2_counts[k] += c[k]
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: (blocks if k == "flash_fwd" else 0) for k in stage2_counts}
    print(f"training recipes (b): {len(batches)} micro steps of {STAGE2_BATCH} rows x {st.data.num_views} views x "
          f"{st.data.image_size}^2, text {st.data.max_length}; walls {[round(w, 3) for w in walls]} s; loss/grad_norm "
          f"{metrics}; launches a micro step {[c['flash_fwd'] for c in per_step]} flash fwd, in the run "
          f"{json.dumps(stage2_counts)}; peak memory {peak:.2f} GiB", flush=True)
    if any(c != want for c in per_step):
        raise AssertionError(f"training recipes (b): launches a micro step {per_step}, expected {want}")
    if any(fa.fwd_copies.values()):
        raise AssertionError(f"training recipes (b): the flash forward copied operands {fa.fwd_copies}")
    if not all(np.isfinite(x) for m in metrics for x in m):
        raise AssertionError(f"training recipes (b): loss or grad_norm not finite: {metrics}")
    if state.opt_state["gradient_step"] != 1:
        raise AssertionError(f"training recipes (b): {state.opt_state['gradient_step']} updates")
    leaves = dict(trainer.named_leaves(state.params))
    for n, fp in prints.items():
        if _fingerprint(leaves[n]) != fp:
            raise AssertionError(f"training recipes (b): frozen leaf {n} changed")
    for n, fps in lora_frozen.items():
        if [_fingerprint(leaves[n][i]) for i in st.freeze_text_layers] != fps:
            raise AssertionError(f"training recipes (b): the adapters of a frozen layer changed ({n})")
    out["stage2"] = dict(walls=walls, peak_gib=peak, counts=stage2_counts, per_step=per_step[0], metrics=metrics,
                         decoded=decoded)
    del state, tx, leaves, step_fn, batches, loader
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the 8-bit update, card against CPU
    out["adam8bit_check"] = reference_check_adam8bit(args.seed)
    return out


RING_VIEWS, RING_TOKENS_A_VIEW = 32, 1029  # the root ring mode's shape: [1, 32·1029, 16, 64]
RING_BAND = 1024  # query rows a band held to the plain version (the whole plain forward needs ~69 GB of scores)


def check_flash_ring(gen) -> dict:
    """Kernel 1 at the root ring mode's shape ``[1, 32·1029, 16, 64]`` (bf16,
    no mask), without and with its lse: the first and the last ``RING_BAND``
    query rows held to the plain version over every key (``held_to_plain``;
    the lse within 1e-3), device times beside SDPA's and the bound."""
    import torch
    import torch.nn.functional as F

    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    S, NH, D = RING_VIEWS * RING_TOKENS_A_VIEW, 16, 64
    q, k, v = (torch.randn(1, S, NH, D, device="cuda", generator=gen).bfloat16() for _ in range(3))
    out = fa.flash_attention(q, k, v)
    out_l, lse = fa.flash_attention_with_lse(q, k, v)
    torch.cuda.synchronize()
    if not torch.equal(out, out_l):
        raise AssertionError("flash_fwd[ring]: the output with lse differs from the one without")
    agree, lse_err = [], 0.0
    for a in (0, S - RING_BAND):
        ref, ref_lse = fa.flash_attention_plain_with_lse(q[:, a:a + RING_BAND], k, v)
        agree.append(held_to_plain(f"flash_fwd[ring rows {a}:{a + RING_BAND}]", out[:, a:a + RING_BAND], ref))
        lse_err = max(lse_err, (lse[:, :, a:a + RING_BAND] - ref_lse).abs().max().item())
        del ref, ref_lse
        torch.cuda.empty_cache()
    if lse_err > 1e-3:
        raise AssertionError(f"flash_fwd lse[ring]: max abs err {lse_err}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = device_ms(lambda: fa.flash_attention(q, k, v), iters=5)
    lse_ms = device_ms(lambda: fa.flash_attention_with_lse(q, k, v), iters=5)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=5)
    flops = 4 * NH * D * S * S
    bms, by = bound_ms(2 * 4 * S * NH * D, flops)
    exp_floor = NH * S * S / (H100_SMS * H100_EXP_PER_SM_CLOCK * sm_clock_hz()) * 1e3
    not_below_bound("flash_fwd (ring shape)", ms, bms)
    res = dict(shape=f"ring q[1,{S},{NH},{D}] kv[1,{S},{NH},{D}] causal=False, rows 0:{RING_BAND} and "
                     f"{S - RING_BAND}:{S} against the plain version",
               ms=ms, lse_ms=lse_ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
               max_abs_err=max(a["max_abs_err"] for a in agree), rel_rms=max(a["rel_rms"] for a in agree),
               lse_max_abs_err=lse_err)
    print(f"flash_fwd_floors[ring] bound_ms {bms:.4f} ({by}); exp_floor_ms {exp_floor:.4f}", flush=True)
    print(f"flash_fwd {json.dumps(res)}", flush=True)
    return res


BENCH_MODES = ("e2e", "qa", "spec", "serve", "serve_sla", "ring")
# timed repetitions of each e2e/qa/spec/ring measurement, after its warm-up call (the root bench's: 3–5)
BENCH_MODE_REPS = 1
BENCH_MODES_ARGV = ["--device", "cuda"]  # the modes' full width on the card (the root bench's shapes and defaults)
# serve_sla's requests a load (the root's 96): at the card's host-bound pace 3 × 96 Poisson arrivals and two
# closed passes of 64 took 137 s of the phase; 32 a load (and closed passes of 32) hold the same paths
BENCH_MODE_ARGV = {"serve_sla": ["--sla_reqs", "32"]}
STEP_W8 = ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8")
PATH_KERNELS = ("flash_fwd", "decode_attention", "block_verify_attention", *STEP_W8, "fused_head_argmax")


def bench_mode_flash_launches(mode: str, res: dict, cfg) -> int:
    """Kernel 1's launches in a mode's run, from its shapes and repetitions:
    a VGGT encode launches one a block (the patch embedder's, then a frame
    and a global block a layer), a prefill one a Qwen3 layer; every timed
    call follows one warm-up call; serve and serve_sla prefill once an
    admission dispatch (the timed pass's or the loads' ``admit_dispatches``
    and those of the passes before it)."""
    vis = cfg.vision.patch_depth + 2 * cfg.vision.num_layers
    pre = cfg.text.num_layers
    calls = 1 + BENCH_MODE_REPS
    if mode == "e2e":  # the whole query and its TTFT; the early-exit curve: one warm-up, then reps a budget
        return (vis + pre) * (2 * calls + 1 + len(res["early_exit"]) * BENCH_MODE_REPS)
    if mode == "qa":
        return (vis + pre) * calls
    if mode == "spec":  # generate and generate_speculative, constrained and free; the action query, plain and spec
        return calls * (4 * pre + 2 * (vis + pre))
    if mode == "serve":
        return pre * (res["warmup_admit_dispatches"] + res["admit_dispatches"])
    if mode == "serve_sla":
        return pre * (res["closed_admit_dispatches"] + res["admit_dispatches"])
    return calls + 2 + 1  # ring: the direct forward's calls, the merge's two halves, the one-rank ring's one step


def bench_mode_launches_ok(mode: str, c: dict, res: dict, cfg) -> list:
    """The launches a mode's run must show (``_counters``): kernel 1 exactly
    ``bench_mode_flash_launches``; kernel 2 in each mode that decodes, and
    each W8 layer kernel once a layer of every decode step and verify block
    (= kernels 2 + 3); kernel 3 only in spec's speculative runs; kernel 7
    only in spec's free ``generate`` (the greedy fast path: penalty 1.0, no
    FSM); the backward kernels never. → the failed rules."""
    decodes = mode != "ring"
    rules = {
        f"flash_fwd = {bench_mode_flash_launches(mode, res, cfg)}":
            c["flash_fwd"] == bench_mode_flash_launches(mode, res, cfg),
        "decode_attention": (c["decode_attention"] > 0) == decodes,
        "block_verify_attention": (c["block_verify_attention"] > 0) == (mode == "spec"),
        "W8 layer kernels = decode + verify": all(
            c[n] == c["decode_attention"] + c["block_verify_attention"] for n in STEP_W8),
        "fused_head_argmax": (c["fused_head_argmax"] > 0) == (mode == "spec"),
        "flash_bwd 0": c["flash_bwd_dq"] == c["flash_bwd_dkv"] == 0,
    }
    return [r for r, ok in rules.items() if not ok]


def _copy(x):
    """A copy of ``x`` with its strides (the layout the launch read)."""
    import torch

    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device).copy_(x)


def _layout(*xs) -> tuple:
    import torch

    return tuple((tuple(x.shape), tuple(x.stride()), str(x.dtype)) if torch.is_tensor(x) else x for x in xs)


@contextlib.contextmanager
def first_launches(seen: dict):
    """Inside the block, each kernel of the bench modes' path (``PATH_KERNELS``)
    has its inputs copied aside at its first launch of every shape and
    layout: ``seen[(kernel, layout)]`` = the inputs (one layer of a cache,
    as the launch reads one; the weights by reference, which nothing
    writes). ``hold_first_launches`` replays them after the run."""
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    flash = fa.flash_fwd_kernel

    def flash_first(q, k, v, start, end, causal, scale, with_lse):
        key = ("flash_fwd", _layout(q, k, v, causal, with_lse))
        if key not in seen:
            seen[key] = (_copy(q), _copy(k), _copy(v), start.clone(), end.clone(), causal, scale, with_lse)
        return flash(q, k, v, start, end, causal, scale, with_lse)

    def attention_first(name):
        kernel = getattr(da, "gqa_" + name)

        def call(q, k, v, li, start, bound, ks=None, vs=None, **kw):
            key = (name, _layout(q, k[li], ks is None, *kw.items()))
            if key not in seen:
                one = [None if t is None else t[li:li + 1].clone() for t in (k, v, ks, vs)]
                seen[key] = ((q.clone(), one[0], one[1], 0, start.clone(), bound.clone(), one[2], one[3]), kw)
            return kernel(q, k, v, li, start, bound, ks, vs, **kw)

        return call

    def w8_first(name):
        kernel = getattr(dm, name)

        def call(x, *ws):
            key = (name, _layout(x))  # one weight tree in the phase
            if key not in seen:
                seen[key] = (x.clone(), *ws)
            return kernel(x, *ws)

        return call

    fa.flash_fwd_kernel = flash_first
    try:
        with qwen3_routed(gqa_decode_attention=attention_first("decode_attention"),
                          gqa_block_verify_attention=attention_first("block_verify_attention"),
                          **{n: w8_first(n) for n in (*STEP_W8, "fused_head_argmax")}):
            yield
    finally:
        fa.flash_fwd_kernel = flash


def hold_first_launches(seen: dict) -> dict:
    """Each launch ``first_launches`` copied aside, run again through its
    kernel and its plain version and held to it: kernel 1 by
    ``held_to_plain`` (above 8 GiB of the plain version's f32 scores, its
    first ``RING_BAND`` query rows against every key), its lse within 1e-3
    and exactly -1e30 on dead rows; kernels 2 and 3, and the W8 layer
    kernels (their outputs together), by ``held_to_plain``; kernel 7's token
    the plain head's argmax or within 1e-4 × max|logit| of it. → kernel →
    [{shape, max_abs_err}]; raises on a disagreement."""
    import torch

    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    held = {}
    for (name, layout), a in seen.items():
        what = f"{name}[{layout[0][0]}]"
        if name == "flash_fwd":
            q, k, v, start, end, causal, scale, with_lse = a
            got, lse = fa.flash_fwd_kernel(*a)
            B, S, NH, _ = q.shape
            rows = S if B * NH * S * k.shape[1] * 4 <= 2**33 else RING_BAND
            ref, ref_lse = fa.flash_attention_plain_with_lse(q[:, :rows], k, v, causal=causal, kv_start=start,
                                                             kv_end=end, scale=scale)
            err = held_to_plain(what, got[:, :rows], ref)["max_abs_err"]
            if with_lse:
                lse, live = lse[:, :, :rows], ref_lse > -1e29
                if (lse[live] - ref_lse[live]).abs().max().item() > 1e-3 or not (lse[~live] == -1e30).all():
                    raise AssertionError(f"{what}: lse off its plain version's")
            shape = f"q{list(q.shape)} kv{list(k.shape)} causal={causal} lse={with_lse}" + (
                f", rows 0:{rows}" if rows < S else "")
            del ref, ref_lse
        elif name in ("decode_attention", "block_verify_attention"):
            args, kw = a
            got = getattr(da, "gqa_" + name)(*args, **kw)
            err = held_to_plain(what, got, getattr(da, f"gqa_{name}_plain")(*args, **kw))["max_abs_err"]
            shape = f"q{list(args[0].shape)} cache{list(args[1].shape[1:])} {args[1].dtype}"
        elif name == "fused_head_argmax":
            x, head = a
            tok, mx = dm.fused_head_argmax(x, head)
            logits = dm.head_logits(x, head)
            top = logits.max(-1).values
            gap = (top - logits.gather(-1, tok.long()[:, None])[:, 0]).max().item()
            if gap > 1e-4 * logits.abs().amax().item():
                raise AssertionError(f"{what}: a token {gap} below the plain head's argmax")
            err = (mx - top).abs().max().item()
            shape = f"x{list(x.shape)}"
            del logits
        else:
            got, ref = getattr(dm, name)(*a), getattr(dm, name + "_plain")(*a)
            got, ref = ((t if isinstance(t, tuple) else (t,)) for t in (got, ref))
            err = held_to_plain(what, torch.cat([g.flatten() for g in got]),
                                torch.cat([r.flatten() for r in ref]))["max_abs_err"]
            shape = f"x{list(a[0].shape)}"
        held.setdefault(name, []).append(dict(shape=shape, max_abs_err=err))
    seen.clear()
    torch.cuda.empty_cache()
    return held


def bench_modes_path(args):
    """The phase "bench modes": the root bench's e2e, qa, spec, serve,
    serve_sla and ring modes through ``vggt_qwen3_tpu_torch.bench``'s mode
    functions at full width, with the root's shapes and defaults, on one
    seeded W8 VLM tree (Qwen3-4B W8, VGGT-1B and the Perceiver bf16; serve
    and serve_sla take its text), ``BENCH_MODE_REPS`` timed repetitions
    after each warm-up instead of the root's 3–5, and serve_sla at 32
    requests a load (``BENCH_MODE_ARGV``) instead of the root's 96. Each
    mode runs with the launch counters set to 0 just before it and read just
    after (``bench_mode_launches_ok``: kernel 1's count exact), with the first
    launch of each kernel at every shape the mode gives it copied aside and
    held to the plain version after the run (``first_launches``,
    ``hold_first_launches``; every kernel the mode launched is held), and
    its output checked: tokens in the vocabulary, early-exit steps = the
    budget and its tokens the whole query's, constrained tokens the FSM's
    cycle, every served request's length its budget, finite latencies, the
    ring's merge and one-rank ring within 0.05 × the output scale."""
    import gc

    import torch

    from vggt_qwen3_tpu_torch import bench
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    margs = {m: bench.parse_args(["--mode", m, "--seed", str(args.seed), *BENCH_MODES_ARGV,
                                  *BENCH_MODE_ARGV.get(m, [])]) for m in BENCH_MODES}
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    params = bench.vlm_params(margs["e2e"])
    cfg = bench.vlm_config(margs["e2e"])
    V = cfg.text.vocab_size
    torch.cuda.synchronize()
    print(f"bench modes: seeded VLM weights ({cfg.text.num_layers}-layer Qwen3 {margs['e2e'].quant}, "
          f"{cfg.vision.num_layers}-pair VGGT and the Perceiver dense) in {time.perf_counter() - t:.1f} s", flush=True)
    out, seen = {}, {}
    for m in BENCH_MODES:
        kw = {} if m == "ring" else dict(params=params)
        if m not in ("serve", "serve_sla"):
            kw["reps"] = BENCH_MODE_REPS
        gc.collect()
        _zero_counters()
        fa.fwd_copies.update(dict.fromkeys(fa.fwd_copies, 0))
        t = time.perf_counter()
        with first_launches(seen):
            res = bench.MODE_FNS[m](margs[m], **kw)
        counts = _counters()
        secs = time.perf_counter() - t
        print(bench.describe(res), flush=True)
        print(f"bench modes [{m}]: {secs:.1f} s; launches {json.dumps(counts)}", flush=True)
        bad = bench_mode_launches_ok(m, counts, res, cfg)
        if bad:
            raise AssertionError(f"bench modes [{m}]: launches {counts} break {bad}")
        if any(fa.fwd_copies.values()):
            raise AssertionError(f"bench modes [{m}]: the flash forward copied operands {fa.fwd_copies}")
        bench_mode_output_ok(m, res, V)
        t = time.perf_counter()
        held = hold_first_launches(seen)
        unheld = [n for n in PATH_KERNELS if counts[n] and n not in held]
        if unheld:
            raise AssertionError(f"bench modes [{m}]: no launch of {unheld} was held to its plain version")
        print(f"bench modes [{m}]: first launch at each shape held to the plain version "
              f"({time.perf_counter() - t:.1f} s): {json.dumps(held)}", flush=True)
        out[m] = dict(res=bench.summary(res), counts=counts, s=secs, held=held)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bench_mode_output_ok(mode: str, res: dict, V: int) -> None:
    """What a mode's output must be (``bench_modes_path``); raises if not."""
    from vggt_qwen3_tpu_torch import bench

    def in_vocab(rows):
        return all(0 <= t < V for row in rows for t in row)

    bad = []
    if not np.isfinite(res["value"]) or res["value"] <= 0:
        bad.append(f"metric {res['value']}")
    if mode == "e2e":
        toks = res["tokens"]
        if len(toks) != 32 or not in_vocab([toks]) or res["first_token"] != toks[0]:
            bad.append("the query's tokens")
        for k, c in res["early_exit"].items():
            if c["steps"] != k or res["early_exit_tokens"][k][:k] != toks[:k]:
                bad.append(f"early exit at budget {k}: {c['steps']} steps")
    elif mode == "qa":
        if len(res["tokens"]) != res["batch"] or not in_vocab(res["tokens"]):
            bad.append("the batch's tokens")
    elif mode == "spec":
        cyc = bench.fsm_cycle(bench.SPEC_CYCLE, V)
        for label, r in res["runs"].items():
            n = len(r["tokens"][0])
            want = [cyc[i % len(cyc)] for i in range(n)]
            if not in_vocab(r["tokens"]) or ("free" not in label and any(row != want for row in r["tokens"])):
                bad.append(f"{label}: tokens not the FSM's cycle")
        free, spec = res["runs"]["generate_free"]["tokens"], res["runs"]["speculative_free"]["tokens"]
        same = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x)) for x, y in zip(free, spec)]
        print(f"bench modes [spec]: free speculative tokens equal generate's for {same} of "
              f"{res['new_tokens']} steps (bf16 near-ties may differ between the schedules)", flush=True)
    elif mode in ("serve", "serve_sla"):
        phases = [res["tokens"]] if mode == "serve" else [res["closed_tokens"]] + [r["tokens"] for r in res["loads"]]
        for toks in phases:  # no EOS: every request runs to its budget
            budgets = bench.serve_workload(V, len(toks), res["prompt"], res["new_tokens"], res["struct"])[1]
            if [len(t) for t in toks] != budgets or not in_vocab(toks):
                bad.append("a served request's tokens or length")
        if mode == "serve_sla" and not all(np.isfinite(r[k]) for r in res["loads"]
                                           for k in ("ttft_p50_ms", "ttft_p99_ms", "wait_p99_ms")):
            bad.append("a latency")
    elif mode == "ring" and not res["ok"]:
        bad.append(f"merge max|Δ| {res['merge_max_abs_diff']}, ring max|Δ| {res['ring_max_abs_diff']}, "
                   f"scale {res['output_scale']}")
    if bad:
        raise AssertionError(f"bench modes [{mode}]: {bad}")


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
    parts = Parts()
    t0 = time.perf_counter()
    params = qa.load_model(stage, rng_seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"main path: random init of {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s", flush=True)
    parts.mark("init")
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
                fa.fwd_copies.update(dict.fromkeys(fa.fwd_copies, 0))
                t = time.perf_counter()
                res = qa.run_inference(params, stage, tok, samples, max_new_tokens=args.max_new_tokens,
                                       batch_size=8, kv_dtype=kv, verbose=False, device="cuda")
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                walls[kv] = secs  # the repeat run's wall time is kept
                counts = (fa.launches, da.launches)
                outs.append((res, [c[0] for c in captured], counts))
                if any(fa.fwd_copies.values()):
                    raise AssertionError(f"kv={kv}: the flash forward copied operands {fa.fwd_copies}")
                steps = counts[1] // stage.model.text.num_layers
                print(f"main path kv={kv or 'bf16'} run {rep}: {secs:.3f} s, decode steps {steps}, "
                      f"flash launches {counts[0]} (operands copied for TMA: {json.dumps(fa.fwd_copies)}), "
                      f"decode launches {counts[1]}, "
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
        parts.mark("bf16 and int8 runs, twice each")
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
        parts.mark("W8 and W8 + LoRA runs")
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
    parts.mark("outputs and host-timed phases")
    # one device-only session: a QA batch holds the generate, whose kernels it shows by family
    profile_breakdown("QA batch", lambda: qa.run_inference(
        params, stage, tok, samples, max_new_tokens=args.max_new_tokens, batch_size=8, verbose=False,
        device="cuda"), unprofiled_s=walls[None])
    parts.mark("profile")
    parts.report("main path")
    del params
    torch.cuda.empty_cache()
    return runs


def w8_bench_path(args):
    """The W8 decode path at full width through the port's bench: Qwen3-4B,
    W8 weights, int8 cache, B=368, prompt 32, 128 greedy steps. The launch
    counters are set to 0 just before the first timed ``generate`` and read
    just after it; the second timed run must give the same tokens."""
    import dataclasses

    import torch

    from vggt_qwen3_tpu_torch import bench
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    bargs = bench.parse_args(["--seed", str(args.seed)])
    counts = {}
    parts = Parts()

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
    parts.mark("setup, warm-up and timed generates")
    short = dataclasses.replace(s.gen_cfg, max_new_tokens=W8_PROFILE_STEPS)
    _, short_s = bench.timed_generate(s, short)
    profile_breakdown(f"W8 generate ({W8_PROFILE_STEPS} steps)", lambda: bench.timed_generate(s, short),
                      unprofiled_s=short_s)
    parts.mark("profile")
    parts.report("W8 bench")
    del s
    torch.cuda.empty_cache()
    return counts, res


QUANT_GATE_SPLITS = ("sqa3d", "scanqa", "arkit")  # evals.baseline's placeholder test splits


def quant_path(args, w8_res: dict):
    """The W8A8 and W4 modes and penalised text generation at full width:

    (a) the port's bench (``bench.setup``, ``bench.timed_generate``) with
    ``--quant w8a8`` (Qwen3-4B, W8A8 layers, the tied W8 embedding, int8
    cache, B=368, prompt 32, 128 greedy steps) after a 2-step warm-up: tok/s
    of one timed ``generate``, the decode step and peak memory beside the W8
    bench's of this run, that generate's launches (counters set to 0 just
    before it: kernels 1, 2 and 7 as the shapes give them, kernels 4–6 none),
    tokens identical on one repeat, and a device-only 2-step profile (the
    int8 GEMMs and any weight copy);
    (b) the quality gate, ``evals.baseline.evaluate`` on the placeholder test
    splits with the full QA stage at random weights: one bf16 pass, compared
    with W8A8 and with W4 weights (int8 cache), 32 new tokens; kernels 4–6
    launch 0 times in each quantized run (counted run by run);
    (c) one QA batch with ``vlm.quantize_vision("w8a8")`` beside ``"w8"``:
    the vision time of each and the distance of their features;
    (d) ``engine.generate_text`` with the prompt penalised (penalty 1.1), 8
    rows of 64 ids, 32 tokens, bf16: launches as the shapes give them, tokens
    identical on the repeat.
    Returns the W8A8 bench's launch counts."""
    import argparse as ap
    import dataclasses
    import tempfile
    import zlib

    import torch

    from vggt_qwen3_tpu_torch import bench
    from vggt_qwen3_tpu_torch.data import dataset
    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.evals import baseline
    from vggt_qwen3_tpu_torch.inference import batching, engine, qa
    from vggt_qwen3_tpu_torch.models import vlm

    # (a) W8A8 decode through the bench
    bargs = bench.parse_args(["--seed", str(args.seed), "--quant", "w8a8"])
    counts = {}

    @contextlib.contextmanager
    def count(i):
        if i == 0:
            _zero_counters()
        yield
        if i == 0:
            torch.cuda.synchronize()
            counts.update(_counters())

    parts = Parts()
    t = time.perf_counter()
    s = bench.setup(bargs)
    torch.cuda.synchronize()
    print(f"W8A8 bench: random init + quantize in {time.perf_counter() - t:.1f} s", flush=True)
    # the W8 bench's protocol without its repetitions: a 2-step warm-up (which also times the 2-step
    # profile's run unprofiled), the prefill alone, and two whole generates: the first counted and
    # timed, the second the repeat that must give its tokens
    short = dataclasses.replace(s.gen_cfg, max_new_tokens=2)
    bench.timed_generate(s, short)
    _, short_s = bench.timed_generate(s, short)
    _, prefill_s = bench.timed_generate(s, dataclasses.replace(s.gen_cfg, max_new_tokens=0))
    torch.cuda.reset_peak_memory_stats()
    walls, tokens = [], []
    for i in range(2):
        with count(i):
            tok_i, secs = bench.timed_generate(s)
        walls.append(secs)
        tokens.append(tok_i)
    B, N, L = bargs.batch, bargs.decode, s.cfg.num_layers
    res = dict(tok_s=B * N / walls[0], walls_s=walls, prefill_s=prefill_s, step_ms=(walls[0] - prefill_s) / N * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, card=bench.card_line())
    print(f"W8A8 bench (Qwen3-4B, W8A8 + int8 KV, B={B}, prompt {bargs.prompt}, {N} steps): {res['tok_s']:.1f} tok/s "
          f"(the first timed generate), walls {res['walls_s']} s, prefill {res['prefill_s'] * 1e3:.1f} ms, decode step "
          f"{res['step_ms']:.2f} ms, peak memory {res['peak_gib']:.2f} GiB; W8 in this run: {w8_res['tok_s']:.1f} "
          f"tok/s, decode step {w8_res['step_ms']:.2f} ms, peak memory {w8_res['peak_gib']:.2f} GiB | {res['card']}",
          flush=True)
    print(f"W8A8 bench launches in one generate: {json.dumps(counts)}", flush=True)
    want = dict.fromkeys(counts, 0)
    want.update(flash_fwd=L, decode_attention=L * N, fused_head_argmax=N + 1)
    if counts != want:
        raise AssertionError(f"W8A8 bench launch counts {counts}, expected {want}")
    t0, t1 = tokens
    if t0.shape != (B, N) or not np.array_equal(t0, t1) or not ((t0 >= 0) & (t0 < s.cfg.vocab_size)).all():
        raise AssertionError("W8A8 bench: the repeat run gave other tokens, or tokens out of range")
    profile_breakdown("W8A8 generate (2 steps)", lambda: bench.timed_generate(s, short), unprofiled_s=short_s)
    del s
    torch.cuda.empty_cache()
    parts.mark("(a) W8A8 bench")

    stage = full_stage()
    params = qa.load_model(stage, rng_seed=args.seed, device="cuda")
    tok = load_tokenizer(None)

    # (b) the quality gate on the placeholder test splits (seeded views for their image files)
    def seeded_rgb(path):
        rng = np.random.default_rng([args.seed, zlib.crc32(str(path).encode())])
        return rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)

    real_rgb, real_run, real_batch = dataset.load_rgb, baseline.run_inference, qa.generate_batch
    runs = []  # every run_inference of the gate: its mode, time, launches and generated tokens

    def counted_run(*a, **kw):
        tokens = []

        def capture(*x, **y):
            out = real_batch(*x, **y)
            tokens.append(out[0].copy())
            return out

        _zero_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        qa.generate_batch = capture
        try:
            out = real_run(*a, **kw)
        finally:
            qa.generate_batch = real_batch
        torch.cuda.synchronize()
        runs.append(dict(mode=kw["quant_mode"] if kw.get("quantize") else "bf16", secs=time.perf_counter() - t,
                         counts=_counters(), tokens=np.concatenate(tokens), records=out))
        return out

    dataset.load_rgb, baseline.run_inference = seeded_rgb, counted_run
    try:
        with tempfile.TemporaryDirectory() as out:
            eargs = baseline.parser().parse_args(
                ["--datasets", *QUANT_GATE_SPLITS, "--num_samples", "8", "--max_new_tokens", str(args.max_new_tokens),
                 "--compare_quant", "--data_root", str(REPO), "--output_dir", out, "--device", "cuda"])
            t = time.perf_counter()
            summary, base = baseline.evaluate(params, stage, tok, ap.Namespace(**{**vars(eargs), "quant_mode": "w8a8"}))
            t_a8 = time.perf_counter() - t
            t = time.perf_counter()
            summary_w4, _ = baseline.evaluate(params, stage, tok, ap.Namespace(**{**vars(eargs), "quant_mode": "w4"}),
                                              base=base)
            t_w4 = time.perf_counter() - t
    finally:
        dataset.load_rgb, baseline.run_inference = real_rgb, real_run
    for name in QUANT_GATE_SPLITS:
        a8, w4 = summary[name], summary_w4[name]
        print(f"quality gate {name} ({a8['total']} samples, random weights): bf16 EM {a8['accuracy']:.1f}%; "
              f"W8A8+int8kv EM {a8['quantized_w8a8_int8kv']['accuracy']:.1f}%, prediction agreement "
              f"{a8['prediction_agreement']}; W4+int8kv EM {w4['quantized_w4_int8kv']['accuracy']:.1f}%, "
              f"prediction agreement {w4['prediction_agreement']}", flush=True)
    for r in runs:
        print(f"quality gate {r['mode']} run: {r['secs']:.3f} s{'' if r['mode'] == 'bf16' else ' incl. quantizing'}, "
              f"launches {json.dumps(r['counts'])}", flush=True)
    quant_runs = [r for r in runs if r["mode"] != "bf16"]
    if [r["mode"] for r in runs] != ["bf16", "w8a8"] * 3 + ["w4"] * 3 or any(
            r["counts"][k] for r in quant_runs for k in ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8")) \
            or any(not r["counts"]["flash_fwd"] or not r["counts"]["decode_attention"] for r in runs):
        raise AssertionError(f"quality gate: runs {[(r['mode'], r['counts']) for r in runs]}")
    # random weights leave the postprocessed answers mostly empty, so the prediction agreement says
    # little: how long each quantized run's tokens follow the bf16 run's says more
    bf16 = [r for r in runs if r["mode"] == "bf16"]
    for mode in ("w8a8", "w4"):
        same, firsts = 0, []
        for ref, got in zip(bf16, [r for r in runs if r["mode"] == mode]):
            for a_row, b_row in zip(ref["tokens"], got["tokens"]):
                diff = np.nonzero(a_row != b_row)[0]
                same += not len(diff)
                firsts.append(int(diff[0]) if len(diff) else len(a_row))
        print(f"quality gate tokens, {mode} + int8 KV against bf16: {same}/{len(firsts)} rows identical over "
              f"{args.max_new_tokens} tokens; first differing step mean {np.mean(firsts):.2f}, min {min(firsts)}; "
              f"non-empty predictions {sum(bool(x['prediction']) for r in bf16 for x in r['records'])} "
              f"(bf16) of {len(firsts)}", flush=True)
    print(f"quality gate: bf16 + W8A8 passes {t_a8:.1f} s, W4 pass {t_w4:.1f} s", flush=True)
    parts.mark("(b) quality gate")

    # (c) the vision tower with W8A8 block weights beside W8
    samples = load_samples(args.seed)
    prompts = [f"{q['question']}\n<image>\n" for q in samples]
    ids, mask = (torch.from_numpy(a).cuda() for a in batching.encode_prompts(
        tok, prompts, pad_to_len=batching.max_prompt_len(tok, prompts)))
    images = batching.stack_views(samples, stage.data.image_size, "cuda")
    vc = stage.model.vision
    feats, vis = {}, {}
    for mode in ("w8", "w8a8"):
        qparams = vlm.quantize_vision(params, mode=mode, donate=False)
        walls = []
        for _ in range(2):
            _zero_counters()
            torch.cuda.synchronize()
            t = time.perf_counter()
            emb, _ = batching.spliced_prompt(qparams, stage, tok.convert_tokens_to_ids("<image>"), images, ids, mask)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        if _counters()["flash_fwd"] != vc.patch_depth + 2 * vc.num_layers or not torch.isfinite(emb.float()).all():
            raise AssertionError(f"vision {mode}: launches {_counters()}, or features not finite")
        t = time.perf_counter()
        res_q = qa.run_inference(qparams, stage, tok, samples, max_new_tokens=args.max_new_tokens, batch_size=8,
                                 kv_dtype="int8", verbose=False, device="cuda")
        torch.cuda.synchronize()
        feats[mode], vis[mode] = emb.float(), dict(vision_s=min(walls), batch_s=time.perf_counter() - t)
        if len(res_q) != len(samples):
            raise AssertionError(f"vision {mode}: {len(res_q)} records")
        del qparams
    rel = ((feats["w8a8"] - feats["w8"]).norm() / feats["w8"].norm()).item()
    print(f"vision tower (VGGT-1B, 8 × 8 views × 448², flash launches {vc.patch_depth + 2 * vc.num_layers}): "
          f"vision+splice W8 {vis['w8']['vision_s']:.3f} s, W8A8 {vis['w8a8']['vision_s']:.3f} s; QA batch W8 "
          f"{vis['w8']['batch_s']:.3f} s, W8A8 {vis['w8a8']['batch_s']:.3f} s; spliced embeddings W8A8 vs W8 rel RMS "
          f"{rel:.4g}", flush=True)
    if not rel < 0.1:
        raise AssertionError(f"vision W8A8 features far from W8's: rel RMS {rel}")
    parts.mark("(c) vision")

    # (d) penalised text generation
    cfg = stage.model.text
    Bt, St, Nt = 8, 64, 32
    tids = torch.from_numpy(np.random.default_rng(args.seed).integers(1, cfg.vocab_size, (Bt, St))).cuda()
    gcfg = engine.GenerationConfig(max_new_tokens=Nt, repetition_penalty=1.1, penalize_prompt=True)
    outs = []
    for _ in range(2):
        _zero_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks, lengths = engine.generate_text(params["text"], cfg, gcfg, input_ids=tids)
        secs = time.perf_counter() - t
        outs.append(toks)
        c = _counters()
        if (c["flash_fwd"], c["decode_attention"]) != (cfg.num_layers, cfg.num_layers * Nt) or \
                any(c[k] for k in ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8", "fused_head_argmax")):
            raise AssertionError(f"generate_text launches {c}")
    if outs[0].shape != (Bt, Nt) or not np.array_equal(*outs) or not (lengths == Nt).all():
        raise AssertionError("generate_text: the repeat gave other tokens, or a wrong shape")
    print(f"generate_text (bf16, penalty 1.1 over the prompt, {Bt} × {St} ids, {Nt} tokens): {secs:.3f} s, "
          f"launches flash {c['flash_fwd']}, decode {c['decode_attention']}; repeat identical", flush=True)
    parts.mark("(d) generate_text")
    parts.report("W8A8/W4 and text path")
    del params
    torch.cuda.empty_cache()
    return counts


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
    parts = Parts()
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

    runs, gaps = [], None
    for spec in (False, True, True):
        stats = []
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fa.launches = da.launches = da.verify_launches = 0
        t = time.perf_counter()
        if spec:
            res = infer(spec, stats=stats)
        else:  # the plain run records its top-2 gaps on the device (a few launches a step), for the near-tie rule
            res, gaps = constrained_gaps(engine, lambda: infer(spec, stats=stats))
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
    parts.mark("init, plain run and two speculative runs")
    if spec_a["res"] != spec_b["res"] or not np.array_equal(spec_a["tokens"], spec_b["tokens"]):
        raise AssertionError("ARKit path: the speculative repeat gave other records")
    n_raw = sum(1 for r in plain["res"] if _parses_to_schema(r["raw_prediction"]))
    print(f"ARKit path: raw_prediction (the reference's brace match) parses to the schema in {n_raw}/"
          f"{len(plain['res'])} plain records; generations parse in all", flush=True)
    if spec_a["res"] == plain["res"] and np.array_equal(spec_a["tokens"], plain["tokens"]):
        print("ARKit path: speculative records and tokens identical to the plain constrained run's", flush=True)
    else:  # the first differing step of each row must be a near-tie of the plain run
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
    parts.mark("holds (verify block, near-ties)")
    torch.cuda.synchronize()
    t = time.perf_counter()
    infer(True, ARKIT_PROFILE_TOKENS)
    torch.cuda.synchronize()
    profile_breakdown(f"ARKit speculative run ({ARKIT_PROFILE_TOKENS} new tokens)",
                      lambda: infer(True, ARKIT_PROFILE_TOKENS), unprofiled_s=time.perf_counter() - t)
    parts.mark("profile")
    parts.report("ARKit path")
    del params
    torch.cuda.empty_cache()
    return plain["counts"], spec_a["counts"]


SERVE_SLOTS, SERVE_BUCKET, SERVE_CHUNK = 8, 64, 4
SERVE_BUDGETS = {9: 8, 11: 16}  # two of the four late requests carry their own budgets
SERVE_HINT = "Answer briefly.\n"


def serve_requests(seed: int):
    """The 12 requests of the serving phase: the 8 ScanQA test questions
    with seeded views, then the first 4 again with other seeded views (two
    with their own ``max_new_tokens``). Images are named by paths the phase's
    loader maps to the seeded views (no image decoder on the card)."""
    samples = load_samples(seed) + load_samples(seed + 1)[:4]
    views, requests = {}, []
    for i, s in enumerate(samples):
        paths = [f"seeded://{i}/{j}.png" for j in range(len(s["images"]))]
        views.update(zip(paths, s["images"]))
        r = {"question": s["question"], "images": paths}
        if i in SERVE_BUDGETS:
            r["max_new_tokens"] = SERVE_BUDGETS[i]
        requests.append(r)
    return requests, views


def _http(port: int, method: str, path: str, payload=None):
    """(status, JSON body, seconds) of one request to the local server."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read()), time.perf_counter() - t


class _Served:
    """A service behind ``ThreadingHTTPServer`` on a free localhost port,
    its slot engine's submissions recorded by request index (the phase's
    image loader tells the handler thread which request it splices)."""

    local = threading.local()  # one for every service: the loader is the server module's

    def __init__(self, service, views):
        from http.server import ThreadingHTTPServer

        from vggt_qwen3_tpu_torch.inference import server

        self.service, self.captured = service, {}

        def load_images(paths):
            _Served.local.idx = int(paths[0].split("/")[2])
            return [views[p] for p in paths]

        server.load_images = load_images
        eng = getattr(service, "engine", None)
        if eng is not None:
            real = eng.submit_embeds

            def recording(embeds, mask, **kw):
                fut = real(embeds, mask, **kw)
                if kw.get("prefix_id") is None:
                    self.captured[_Served.local.idx] = (embeds, mask, fut)
                return fut

            eng.submit_embeds = recording
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(service))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def drive(self, requests, late: int = 0):
        """Post ``requests`` concurrently; the last ``late`` of them once the
        engine has run a chunk after the first were sent. → (responses in
        request order, seconds from the first post to the last answer)."""
        eng = getattr(self.service, "engine", None)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(requests)) as ex:
            chunks0 = eng.stats.chunks if eng is not None else 0
            futs = [ex.submit(_http, self.port, "POST", "/v1/qa", r) for r in requests[:len(requests) - late]]
            while late and eng.stats.chunks <= chunks0:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("serving: no decode chunk ran within 300 s")
                time.sleep(0.002)
            futs += [ex.submit(_http, self.port, "POST", "/v1/qa", r) for r in requests[len(requests) - late:]]
            out = [f.result() for f in futs]
        return out, time.perf_counter() - t0

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.stop()


def _zero_counters():
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    fa.launches = fa.dq_launches = fa.dkv_launches = da.launches = da.verify_launches = 0
    dm.launches.update(dict.fromkeys(dm.launches, 0))


def _counters() -> dict:
    """Every wrapper's launch count, by kernel name (those of the kernels line)."""
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    return dict(flash_fwd=fa.launches, decode_attention=da.launches, block_verify_attention=da.verify_launches,
                **dm.launches, flash_bwd_dq=fa.dq_launches, flash_bwd_dkv=fa.dkv_launches)


def serve_witness(params, cfg, items, T_slot: int, N: int, K: int = DRAFT_K + 1):
    """How far the serving schedules' logits lie from ``engine.generate``'s
    at B = 1 on the card, on the same tokens (each request's first K served
    tokens, teacher-forced): the 8 first requests' spliced prompts prefilled
    together into an int8 cache of the slot engine's row length ``T_slot``,
    then K − 1 one-token decode steps (8 rows) or one K-token verify block
    (8 × K rows, the speculative chunks' block), against each request alone
    in ``engine.generate``'s cache of S + N slots through K − 1 decode steps.

    Measured twice: with qwen3's attention routed through the plain versions
    (the schedules' noise, as in ``schedule_witness``), and with the kernels
    (their rounding against the plain versions), every kernel call of that
    second run held to its plain version on the same inputs
    (``utils.agreement``, tol 2e-2): decode attention at 8 rows over
    ``T_slot`` slots and at 1 row, block verify at 8 × K rows, the fused W8
    groups (which the first run runs too) at 8, 8 × K and 1 rows; a kernel
    outside that tolerance fails here instead of widening the result.
    → (schedule noise, kernels vs plain), each the max over rows and steps
    of max|Δlogit| / max|logit|."""
    import torch
    import torch.nn.functional as F

    dev = items[0][0].device
    S = max(e.shape[1] for e, _, _ in items)
    emb = torch.cat([F.pad(e, (0, 0, S - e.shape[1], 0)) for e, _, _ in items])
    mask = torch.cat([F.pad(m.to(dev).int(), (S - m.shape[1], 0)) for _, m, _ in items])
    toks = torch.stack([torch.from_numpy(np.pad(t[:K], (0, max(0, K - len(t))))) for _, _, t in items]).to(dev)
    held, logits = [], {}
    for route, fns in (("plain", plain_attention()), ("kernels", held_kernels(held))):
        with qwen3_routed(**fns):
            decode = teacher_forced(params, cfg, emb, mask, toks[:, :K - 1], T_slot, block=False, kv_dtype="int8")
            verify = teacher_forced(params, cfg, emb, mask, toks, T_slot, block=True, kv_dtype="int8")[:, :K - 1]
            alone = torch.cat([teacher_forced(params, cfg, e, m, toks[r:r + 1, :K - 1], e.shape[1] + N,
                                              block=False, kv_dtype="int8") for r, (e, m, _) in enumerate(items)])
        logits[route] = decode, verify, alone
    decode, verify, alone = logits["plain"]
    noise = max(_rel(decode, alone), _rel(verify, alone))
    kernels = max(_rel(k, p) for k, p in zip(logits["kernels"], logits["plain"]))
    worst = {}
    for name, rows, h in held:
        w = worst.setdefault(f"{name} ({rows} rows)", dict(outputs=0, ok=True, rel_rms=0.0))
        w["outputs"] += 1
        w["ok"] &= h["ok"]
        w["rel_rms"] = max(w["rel_rms"], h["rel_rms"])
    print(f"serving path: kernel calls of the teacher-forced schedules held to their plain versions (rel_rms limit "
          f"5e-3): {json.dumps(worst)}", flush=True)
    if not all(h["ok"] for _, _, h in held) or {n for n, _, _ in held} != set(STEP_KERNELS):
        raise AssertionError("serving path: a kernel disagrees with its plain version at the serving shapes")
    return noise, kernels


def held_to_slots(spec_served, served, refs, limit: float) -> int:
    """The speculative service's tokens against the slots service's, under
    the rule of ``held_to_generate``: identical, or differing first at a
    step whose top-2 gap in ``engine.generate``'s run (``refs``) is under
    ``limit``. Where the slots run already left the reference before that
    step, its own first departure is the step judged. Returns the number of
    identical requests."""
    same, firsts = 0, []
    for idx, (_, _, toks) in sorted(served.items()):
        other = spec_served[idx][2]
        ref, gaps = refs[idx]
        n = min(len(toks), len(other))
        diff = np.nonzero(toks[:n] != other[:n])[0]
        t = int(diff[0]) if len(diff) else n
        if t == len(toks) == len(other):
            same += 1
            continue
        left = np.nonzero(ref[:len(toks)] != toks)[0]
        judged = min(t, int(left[0])) if len(left) else t
        firsts.append((idx, t, judged, float(gaps[judged])))
        if not gaps[judged] < limit:
            raise AssertionError(f"serving: speculative request {idx} differs from the slots run's at step {t}, "
                                 f"judged at step {judged} (top-2 gap {gaps[judged]:.3e} ≥ {limit:.3e})")
    print(f"serving (speculative vs slots): {same}/{len(served)} identical; (request, first differing step, step "
          f"judged, gap there) {firsts}", flush=True)
    return same


def held_to_generate(label, params, cfg, gen_cfg, served, limit: float, refs: dict):
    """Each served request's tokens against ``engine.generate`` of its
    spliced prompt at B = 1 (``refs`` caches it by request index: tokens
    and the top-2 gap of each step relative to max|logit|): identical, or
    differing first at a step whose gap is under ``limit``. Returns
    (decisive requests, decisive and identical, identical)."""
    import torch

    from vggt_qwen3_tpu_torch.inference import engine

    counts = [0, 0, 0]
    firsts = []
    for idx, (emb, mask, toks) in sorted(served.items()):
        if idx not in refs:
            with torch.inference_mode():
                (ref, _), gaps = constrained_gaps(engine, lambda: engine.generate(
                    params, cfg, gen_cfg, inputs_embeds=emb, attention_mask=mask))
            refs[idx] = (ref[0], gaps[:, 0])
        ref, gaps = refs[idx]
        n = len(toks)
        decisive = bool(gaps[:n].min() >= limit)
        diff = np.nonzero(ref[:n] != toks)[0]
        same = not len(diff)
        counts[0] += decisive
        counts[1] += decisive and same
        counts[2] += same
        if not same:
            t = int(diff[0])
            firsts.append((idx, t, float(gaps[t])))
            if not gaps[t] < limit:
                raise AssertionError(f"{label}: request {idx} differs from engine.generate at a decisive step {t} "
                                     f"(top-2 gap {gaps[t]:.3e} ≥ {limit:.3e})")
    print(f"{label}: held to engine.generate at B = 1 (a flip needs a top-2 gap under {limit:.3e} of max|logit|): "
          f"{len(served)} requests, decisive {counts[0]}, decisive and identical {counts[1]}, identical {counts[2]}; "
          f"first differing step and gap there {firsts}", flush=True)
    return tuple(counts)


def serve_path(args, smi: str):
    """The serving path at full width through the port's HTTP server: the
    stage of ``configs/stage1_3d.yaml`` with the server's defaults (W8 text
    weights, W8 VGGT blocks, int8 KV cache), 8 slots, 32 new tokens, prompt
    bucket 64, decode chunk 4, the byte tokenizer. 12 ScanQA requests over
    localhost through the slots service (8 at once, 4 once the first chunk
    ran), again under the profiler, through the speculative slots service,
    8 through the batch service; then on each slot engine a registered
    prefix and two requests on it (the chunked prefill, then decode or
    verify blocks over holed rows: kernels 2 and 3 must not launch).
    Returns the launch counts of the slots run, the speculative run and the
    batch run."""
    import dataclasses

    import torch

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference import qa, server
    from vggt_qwen3_tpu_torch.models import qwen3, vlm

    stage = full_stage()
    cfg, L = stage.model.text, stage.model.text.num_layers
    vc = stage.model.vision
    per_splice = vc.patch_depth + 2 * vc.num_layers
    t0 = time.perf_counter()
    params = qa.load_model(stage, rng_seed=args.seed, device="cuda")
    params = dict(params, text=qwen3.quantize_params(dict(params["text"])))
    params = vlm.quantize_vision(params, mode="w8")
    torch.cuda.synchronize()
    print(f"serving path: random init, W8 text and W8 VGGT blocks in {time.perf_counter() - t0:.1f} s", flush=True)
    tok = load_tokenizer(None)
    requests, views = serve_requests(args.seed)
    real_loader = server.load_images
    kw = dict(num_slots=SERVE_SLOTS, max_new_tokens=args.max_new_tokens, prompt_bucket=SERVE_BUCKET,
              decode_chunk=SERVE_CHUNK, kv_dtype="int8", track_metrics=True)
    runs, refs = {}, {}
    parts = Parts()
    mark = parts.mark

    try:
        slots = _Served(server.SlotQAService(stage, tok, params, **kw), views)
        eng = slots.service.engine
        drive = lambda: slots.drive(requests, late=4)  # noqa: E731
        slots.drive(requests[:1])  # warm-up: the first splice, admission and decode
        mark("slots warm-up")
        slots.captured.clear()
        eng.req_meta.clear()
        before = _http(slots.port, "GET", "/healthz")[1]
        s0 = dataclasses.replace(eng.stats)
        torch.cuda.synchronize()
        _zero_counters()
        out, wall = drive()
        torch.cuda.synchronize()
        counts = _counters()
        after = _http(slots.port, "GET", "/healthz")[1]
        steps = (eng.stats.chunks - s0.chunks) * SERVE_CHUNK
        admits = eng.stats.admit_dispatches - s0.admit_dispatches
        codes = [c for c, _, _ in out]
        if codes != [200] * len(requests) or not all(isinstance(b.get("prediction"), str) for _, b, _ in out):
            raise AssertionError(f"serving (slots): statuses {codes}")
        if after["requests"] - before["requests"] != len(requests) or after["tokens"] <= before["tokens"] \
                or eng.stats.admitted_mid_decode - s0.admitted_mid_decode < 1:
            raise AssertionError(f"serving (slots): /healthz {before} → {after}, stats {eng.stats}")
        want = dict(flash_fwd=per_splice * len(requests) + L * admits, decode_attention=L * steps,
                    block_verify_attention=0, fused_qkv_w8=L * steps, fused_linear_w8=L * steps,
                    fused_mlp_w8=L * steps, fused_head_argmax=0, flash_bwd_dq=0, flash_bwd_dkv=0)
        if counts != want:
            raise AssertionError(f"serving (slots): launches {counts}, expected {want}")
        lat = sorted(t for _, _, t in out)
        meta = [eng.req_meta.pop(f) for _, _, f in slots.captured.values()]
        e2e = sorted(m["done"] - m["submit"] for m in meta)
        ttft = sorted(m["first_tok"] - m["submit"] for m in meta)
        served = {i: (e, m, f.result()[0]) for i, (e, m, f) in slots.captured.items()}
        n_tok = sum(len(t) for _, _, t in served.values())
        print(f"serving path (slots, {len(requests)} requests over HTTP, {SERVE_SLOTS} slots, W8 + int8 KV): "
              f"{wall:.3f} s, {len(requests) / wall:.3f} requests/s, {n_tok / wall:.1f} tokens/s; request latency "
              f"p50 {np.percentile(lat, 50):.3f} s, p95 {np.percentile(lat, 95):.3f} s (HTTP); engine submit→done "
              f"p50 {np.percentile(e2e, 50):.3f}, p95 {np.percentile(e2e, 95):.3f} s, first token p50 "
              f"{np.percentile(ttft, 50):.3f} s (track_metrics); {eng.stats.chunks - s0.chunks} chunks, "
              f"{admits} admissions ({eng.stats.admitted_mid_decode - s0.admitted_mid_decode} mid-decode), "
              f"KV occupancy {eng.stats.kv_utilization:.3f}; launches {json.dumps(counts)} | {smi}", flush=True)
        runs["slots"] = counts
        mark("slots run")

        spec = _Served(server.SlotQAService(stage, tok, params, speculative=True, draft_k=DRAFT_K, spec_chunk=4,
                                            **kw), views)
        seng = spec.service.engine
        # random weights leave drafts little chance: the guard (1.35 tokens a
        # block) would turn verify blocks off; at 0.5 it never trips and
        # still counts the blocks
        seng.spec_min_gain = 0.5
        spec.drive(requests[:1])  # warm-up
        spec.captured.clear()
        s0 = dataclasses.replace(seng.stats)
        torch.cuda.synchronize()
        _zero_counters()
        out, swall = spec.drive(requests, late=4)
        torch.cuda.synchronize()
        counts = _counters()
        if [c for c, _, _ in out] != [200] * len(requests):
            raise AssertionError(f"serving (speculative): statuses {[c for c, _, _ in out]}")
        blocks = seng.stats.spec_blocks - s0.spec_blocks
        n_blocks = (seng.stats.chunks - s0.chunks) * 4
        admits = seng.stats.admit_dispatches - s0.admit_dispatches
        want = dict(flash_fwd=per_splice * len(requests) + L * admits, decode_attention=0,
                    block_verify_attention=L * n_blocks, fused_qkv_w8=L * n_blocks, fused_linear_w8=L * n_blocks,
                    fused_mlp_w8=L * n_blocks, fused_head_argmax=0, flash_bwd_dq=0, flash_bwd_dkv=0)
        if counts != want or seng.stats.spec_disabled_at is not None:
            raise AssertionError(f"serving (speculative): launches {counts}, expected {want}")
        spec_served = {i: (e, m, f.result()[0]) for i, (e, m, f) in spec.captured.items()}
        same_as_slots = sum(np.array_equal(spec_served[i][2], served[i][2]) for i in served)
        print(f"serving path (speculative slots, k={DRAFT_K}, 4 blocks a chunk): {swall:.3f} s, "
              f"{len(requests) / swall:.3f} requests/s; {blocks} verify blocks, "
              f"{(seng.stats.spec_accepted - s0.spec_accepted) / max(blocks, 1):.3f} tokens a block (all active "
              f"slots); tokens identical to the slots run's in "
              f"{same_as_slots}/{len(served)}; launches {json.dumps(counts)} | {smi}", flush=True)
        runs["spec"] = counts
        mark("speculative warm-up and run")

        # one profiled window: 2 requests to the slots service and 1 to the
        # speculative one at once, 8 new tokens each — kernels 1–6 in one session
        window = [dict(r, max_new_tokens=8) for r in requests[:2]]
        spec_window = [dict(requests[4], max_new_tokens=8)]

        def both():
            with ThreadPoolExecutor(max_workers=2) as ex:
                for f in [ex.submit(slots.drive, window), ex.submit(spec.drive, spec_window)]:
                    f.result()

        torch.cuda.synchronize()
        t = time.perf_counter()
        both()
        torch.cuda.synchronize()
        missed = profile_breakdown(f"serving window (2 requests to the slots service, 1 to the speculative one) | {smi}",
                                   both, unprofiled_s=time.perf_counter() - t, tries=5)
        if missed:
            raise AssertionError(f"serving: the profiler saw fewer launches than the wrappers counted {missed}")
        mark("profile window")
        noise, kdist = serve_witness(params["text"], cfg, [served[i] for i in range(8)], eng._row_len,
                                     args.max_new_tokens)
        limit = max(1e-3, 2 * max(noise, kdist))
        print(f"serving path: the same tokens teacher-forced through 8 rows in a {eng._row_len}-slot cache (decode "
              f"steps, and a {DRAFT_K + 1}-token verify block) and through 1 row in engine.generate's cache give "
              f"logits that differ by up to {noise:.3e} of max|logit| with plain attention; the kernels' logits lie "
              f"up to {kdist:.3e} from the plain versions' on the same schedules; a flip needs a top-2 gap under "
              f"{limit:.3e}", flush=True)
        mark("noise witness")
        runs["slots_held"] = held_to_generate("serving (slots)", params["text"], cfg, slots.service.gen_cfg, served,
                                              limit, refs)
        mark("B = 1 references")
        runs["slots_prefix"] = prefixed(eng, tok, params["text"], cfg, served, "slots")
        runs["spec_held"] = held_to_generate("serving (speculative)", params["text"], cfg, spec.service.gen_cfg,
                                             spec_served, limit, refs)
        held_to_slots(spec_served, served, refs, limit)
        runs["spec_prefix"] = prefixed(seng, tok, params["text"], cfg, spec_served, "speculative")
        spec.close()
        slots.close()
        mark("speculative held, prefixes")

        batch = _Served(server.QAService(stage, tok, params, max_batch=SERVE_SLOTS, max_wait_ms=50,
                                         max_new_tokens=args.max_new_tokens, prompt_bucket=SERVE_BUCKET,
                                         kv_dtype="int8"), views)
        torch.cuda.synchronize()
        _zero_counters()
        out, bwall = batch.drive(requests[:SERVE_SLOTS])
        torch.cuda.synchronize()
        counts = _counters()
        batch.close()
        N = args.max_new_tokens
        want = dict(flash_fwd=per_splice + L, decode_attention=L * N, block_verify_attention=0,
                    fused_qkv_w8=L * N, fused_linear_w8=L * N, fused_mlp_w8=L * N, fused_head_argmax=0,
                    flash_bwd_dq=0, flash_bwd_dkv=0)
        if [c for c, _, _ in out] != [200] * SERVE_SLOTS or counts != want:
            raise AssertionError(f"serving (batch): statuses {[c for c, _, _ in out]}, launches {counts}, "
                                 f"expected {want}")
        print(f"serving path (batch service, {SERVE_SLOTS} requests coalesced): {bwall:.3f} s, "
              f"{SERVE_SLOTS / bwall:.3f} requests/s; launches {json.dumps(counts)} | {smi}", flush=True)
        runs["batch"] = counts
        mark("batch")
        parts.report("serving path")
    finally:
        server.load_images = real_loader
    del params
    torch.cuda.empty_cache()
    return runs


def prefixed(eng, tok, params, cfg, served, label):
    """A system hint registered as a prefix on a running slot engine and
    two requests admitted on it (the two shortest spliced prompts, their
    left pads dropped, as suffixes; 8 new tokens each): the chunked
    prefill, then every step over holed rows. Kernels 2 and 3 must not launch after the
    prefixed admission, nor kernel 1 (the chunked prefill is plain
    attention); the fused W8 kernels run every step. Returns the launch
    counts."""
    import torch

    from vggt_qwen3_tpu_torch.models import qwen3

    L = cfg.num_layers
    hint = torch.tensor([tok(SERVE_HINT, add_special_tokens=False)["input_ids"]], device="cuda")
    with torch.inference_mode():
        hint_emb = qwen3.embed_tokens(params, hint)
    pid = eng.register_prefix(hint_emb)
    suffixes = []
    for emb, mask, _ in sorted(served.values(), key=lambda s: int(s[1].sum()))[:2]:
        pad = int((mask == 0).sum())
        suffixes.append((emb[:, pad:], mask[:, pad:]))
    torch.cuda.synchronize()
    c0 = eng.stats.chunks
    _zero_counters()
    futs = [eng.submit_embeds(e, m, prefix_id=pid, max_new_tokens=8) for e, m in suffixes]
    res = [f.result(timeout=300) for f in futs]
    torch.cuda.synchronize()
    counts = _counters()
    fused = [counts[k] for k in ("fused_qkv_w8", "fused_linear_w8", "fused_mlp_w8")]
    idle = ("decode_attention", "block_verify_attention", "flash_fwd", "fused_head_argmax", "flash_bwd_dq",
            "flash_bwd_dkv")
    if eng._frontier_ok or any(counts[k] for k in idle) or not all(n > 0 and n % L == 0 for n in fused):
        raise AssertionError(f"serving ({label}) after a prefixed admission: launches {counts}")
    if not all(0 < n <= 8 for _, n in res):
        raise AssertionError(f"serving ({label}) prefixed requests: {[n for _, n in res]} tokens")
    print(f"serving path ({label}): a prefix of {hint.shape[1]} tokens and 2 requests on it "
          f"({[e.shape[1] for e, _ in suffixes]}-token suffixes): {[n for _, n in res]} tokens in "
          f"{eng.stats.chunks - c0} chunks, launches {json.dumps(counts)}", flush=True)
    return counts


STEP_KERNELS = ("gqa_decode_attention", "gqa_block_verify_attention", "fused_qkv_w8", "fused_linear_w8",
                "fused_mlp_w8")  # what qwen3's decode steps and verify blocks launch


@contextlib.contextmanager
def qwen3_routed(**fns):
    """qwen3's kernel entry points (``STEP_KERNELS``) replaced by ``fns``
    inside the block."""
    from vggt_qwen3_tpu_torch.models import qwen3

    real = {n: getattr(qwen3, n) for n in fns}
    for n, f in fns.items():
        setattr(qwen3, n, f)
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(qwen3, n, f)


def plain_attention() -> dict:
    """qwen3's decode and verify attention routed through the plain versions."""
    from vggt_qwen3_tpu_torch.ops import decode_attention as da

    return dict(gqa_decode_attention=da.gqa_decode_attention_plain,
                gqa_block_verify_attention=da.gqa_block_verify_attention_plain)


def held_kernels(held: list, names=STEP_KERNELS) -> dict:
    """qwen3's kernel entry points ``names``, each call's output held to its
    plain version on the same inputs (``utils.agreement``, tol 2e-2):
    (name, rows, agreement) is appended to ``held`` for every output."""
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.utils.agreement import agreement

    def hold(name):
        mod = da if name.startswith("gqa_") else dm
        kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")

        def call(*a):
            got, ref = kernel(*a), plain(*a)
            rows = a[0].shape[0] * (a[0].shape[1] if name == "gqa_block_verify_attention" else 1)
            for g, r in zip(*((t if isinstance(t, tuple) else (t,)) for t in (got, ref))):
                held.append((name, rows, agreement(g, r)))
            return got

        return call

    return {n: hold(n) for n in names}


def teacher_forced(params, cfg, emb, mask, toks, T: int, *, block: bool, kv_dtype=None):
    """Logits after each token of ``toks`` [B, n], teacher-forced through
    qwen3 (its kernel entry points as routed): the left-padded prompts
    ``emb`` [B, S, H] / ``mask`` [B, S] prefilled into a cache of ``T``
    slots, then ``toks`` as n one-token decode steps, or (``block``) as one
    n-token verify block at the frontier. → [B, n, V] float32."""
    import torch
    import torch.nn.functional as F

    from vggt_qwen3_tpu_torch.models import qwen3

    B, S, _ = emb.shape
    dev, n = emb.device, toks.shape[1]
    mask = mask.to(dev).int()
    am = F.pad(mask, (0, T - S))
    pos = torch.clamp_min(torch.cumsum(mask, -1) - 1, 0)
    jpos = torch.arange(n, device=dev)
    with torch.inference_mode():
        cache = qwen3.init_cache(cfg, B, T, dtype=kv_dtype, device=dev)
        qwen3.forward(params, cfg, inputs_embeds=emb, attention_mask=am, positions=pos, cache=cache,
                      prefill_padding="left", last_logit_only=True)
        if block:
            tpos = torch.arange(T, device=dev)[None, None, :]
            bm = torch.where(tpos < S, am.bool()[:, None, :], (tpos - S) <= jpos[None, :, None]).int()
            return qwen3.forward(params, cfg, input_ids=toks, attention_mask=bm,
                                 positions=pos[:, -1:] + 1 + jpos[None, :], cache=cache,
                                 cache_offset=torch.full((B,), S, device=dev), decode_frontier=True)[0].float()
        out = []
        for j in range(n):
            am[:, S + j] = 1
            logits, cache = qwen3.forward(params, cfg, input_ids=toks[:, j:j + 1], attention_mask=am,
                                          positions=pos[:, -1:] + 1 + j, cache=cache, cache_offset=S + j,
                                          decode_frontier=True)
            out.append(logits[:, 0])
    return torch.stack(out, 1).float()


def _rel(a, b) -> float:
    """max over rows and steps of max|a − b| / max|b| (logits [B, n, V])."""
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def schedule_witness(params, stage, tok, samples, tokens) -> float:
    """How far the two decode schedules' logits differ on the same tokens,
    with no kernel of the path in them: after a prefill of the ARKit batch,
    six one-token decode steps (GEMMs at 4 rows) against one 7-token verify
    block (GEMMs at 28 rows) over the plain run's first tokens, both with
    qwen3's attention routed through the plain versions on the card.
    Returns the max over rows and positions of max|Δlogit| / max|logit|.

    The same verify block then runs with the block-verify kernel, each
    layer's call held to the plain version on the same inputs
    (``utils.agreement``, tol 2e-2); its logits' distance from the plain
    block is printed."""
    import torch

    from vggt_qwen3_tpu_torch.inference import arkit, batching

    cfg, K = stage.model.text, DRAFT_K + 1
    prompts = [arkit.prompt_for(s["question"]) for s in samples]
    pad_to = batching.max_prompt_len(tok, prompts)
    ids, mask = (torch.from_numpy(a).cuda() for a in batching.encode_prompts(tok, prompts, pad_to_len=pad_to))
    images = batching.stack_views(samples, stage.data.image_size, "cuda")
    emb, m2 = batching.spliced_prompt(params, stage, tok.convert_tokens_to_ids("<image>"), images, ids, mask)
    T = emb.shape[1] + K
    blk = torch.from_numpy(np.ascontiguousarray(tokens[:, :K])).cuda()
    held = []
    with qwen3_routed(**plain_attention()):
        steps = teacher_forced(params["text"], cfg, emb, m2, blk[:, :K - 1], T, block=False)
        verify_plain = teacher_forced(params["text"], cfg, emb, m2, blk, T, block=True)
    with qwen3_routed(**held_kernels(held, ("gqa_block_verify_attention",))):
        verify_kernel = teacher_forced(params["text"], cfg, emb, m2, blk, T, block=True)
    worst = max((h for _, _, h in held), key=lambda h: h["rel_rms"])
    print(f"ARKit path: verify block with the kernel vs with the plain version: logits differ by up to "
          f"{_rel(verify_kernel, verify_plain):.3e} of max|logit|; each of {len(held)} kernel calls held to the "
          f"plain version on its inputs, worst {json.dumps(worst)}", flush=True)
    if len(held) != cfg.num_layers or not all(h["ok"] for _, _, h in held):
        raise AssertionError("ARKit path: the block-verify kernel disagrees with its plain version in the verify block")
    return _rel(verify_plain[:, :K - 1], steps)


def _parses_to_schema(text: str) -> bool:
    try:
        return list(json.loads(text)) == SCHEMA_KEYS
    except (ValueError, TypeError):
        return False


def family(name: str) -> str:
    """The profile family of a device kernel's name."""
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
    if any(k in n for k in ("head_argmax_kernel", "head_reduce_kernel", "head_tile_kernel")):
        return "head_argmax (ours)"  # head_tile_kernel: the name in trees before the wgmma head
    if "gemm_s8" in n:  # torch._int_mm's cutlass kernels (W8A8)
        return "int8 matmul (cuBLASLt, W8A8)"
    if any(w in n for w in ("gemm", "nvjet", "sm90_", "cutlass", "cublas", "xmma", "gemv")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, copies, reductions)"


def our_launches() -> dict:
    """The kernels of our families launched so far, by family, from the
    wrappers' launch counters (fused_mlp_w8 launches w8_swiglu and a
    w8_gemm, fused_head_argmax two kernels, a count each)."""
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
    from vggt_qwen3_tpu_torch.ops import decode_matmul as dm
    from vggt_qwen3_tpu_torch.ops import flash_attention as fa

    w8 = dm.launches
    return {"flash_fwd (ours)": fa.launches, "flash_bwd_dq (ours)": fa.dq_launches,
            "flash_bwd_dkv (ours)": fa.dkv_launches, "decode_attention (ours)": da.launches,
            "block_verify_attention (ours)": da.verify_launches,
            "W8 GEMM w8_gemm: qkv, wo, down (ours)": w8["fused_qkv_w8"] + w8["fused_linear_w8"] + w8["fused_mlp_w8"],
            "W8 gate/up w8_swiglu (ours)": w8["fused_mlp_w8"], "head_argmax (ours)": 2 * w8["fused_head_argmax"]}


def missed_launches(launched: dict, kernel_names: list) -> dict:
    """{family: (kernels the profiler saw, kernels launched)} for each of our
    families whose launches (``launched``: by family, in the profiled run)
    the profiler did not all see (``kernel_names``: one a device kernel)."""
    seen = {}
    for n in kernel_names:
        seen[family(n)] = seen.get(family(n), 0) + 1
    return {f: (seen.get(f, 0), n) for f, n in launched.items() if seen.get(f, 0) < n}


def device_events(prof) -> list:
    """The device records of a finished ``torch.profiler`` session, (name,
    start µs, end µs), read from its raw Kineto events: ``prof.events()``
    first builds the host-side event tree, tens of microseconds an event in
    Python, which at a path profile's ~10⁵ events costs tens of seconds."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            out.append((e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
    return out


def profile_breakdown(label: str, run, unprofiled_s: float, tries: int = 3, marked_range=None):
    """One more run of a main-path phase under torch.profiler, tracing the
    device only (no host ops: less overhead for a host-bound run): device
    time by kernel family and by kernel. The profiler slows the host, so the
    idle share is also given against ``unprofiled_s``, the same run's wall
    time without it. With ``marked_range`` = (family, n), the run brackets
    each range with a ``torch.cuda._sleep`` marker kernel on either side (n
    markers in all), and the kernels that start between the two markers of
    a pair count to that family. A session that saw fewer kernels of one of
    our families than its wrappers launched is run again, ``tries`` sessions
    in all; each family line gives its launches, and if none of the sessions
    saw them all, the last one's lines say how many it saw ("short"): their
    figures miss those launches' time. Returns those of the last session,
    {family: (seen, launched)} (empty when it saw every launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        before = our_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
            profiler_pad()
        launched = {f: n - before[f] for f, n in our_launches().items() if n > before[f]}
        events = device_events(prof)
        kernels = [e for e in events if PAD_KERNEL not in e[0]]
        missed = missed_launches(launched, [name for name, _, _ in kernels])
        if not missed:
            break
        print(f"profile {label}: the session missed launches (seen, launched) {json.dumps(missed)}", flush=True)
    by_name, ranged, each = {}, {}, {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + end - start
        each.setdefault(name, []).append(end - start)
    range_family = None
    if marked_range is not None:
        range_family, n_marks = marked_range
        marks = sorted((e for e in events if PAD_KERNEL in e[0]), key=lambda e: e[1])[:n_marks]
        if len(marks) < n_marks:  # the profiler pad's kernels come after the run's markers
            print(f"profile {label}: {len(marks)} of {n_marks} range markers seen: no {range_family!r} range",
                  flush=True)
        spans = [(marks[i][2], marks[i + 1][1]) for i in range(0, len(marks) - 1, 2)]
        for name, start, end in kernels:
            if any(a <= start < b for a, b in spans):
                ranged[name] = ranged.get(name, 0.0) + end - start
        if not ranged:
            print(f"profile {label}: no kernel ran between the {range_family!r} markers", flush=True)
    busy = sum(by_name.values())
    if busy <= 0:
        print(f"profile {label}: the profiler saw no device time", flush=True)
        return missed or {"device time": (0, 1)}

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
        n = f", {launched[f_name]} launches (all seen)" if f_name in launched else ""
        if f_name in missed:
            n = f", {launched[f_name]} launches (short: the profiler saw {missed[f_name][0]})"
        print(f"profile {label} family: {f_name}: {us / 1e3:.1f} ms ({us / busy:.3f}){n}", flush=True)
    for f_name in sorted(missed.keys() - fam.keys()):
        print(f"profile {label} family: {f_name}: {launched[f_name]} launches (short: the profiler saw none)",
              flush=True)
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile {label} kernel: {n[:90]}: {us / 1e3:.1f} ms ({us / busy:.3f})", flush=True)
    # kernel 1 by template instance (D = 64: VGGT; D = 128: the Qwen3 prefill), each launch's device ms
    for n in sorted(n for n in by_name if family(n) == "flash_fwd (ours)"):
        d = sorted(each[n], reverse=True)
        print(f"profile {label} flash_fwd instance {n[n.find('flash_fwd_kernel'):].split('(')[0]}: {len(d)} launches, "
              f"{sum(d) / 1e3:.1f} ms; each (ms) {[round(x / 1e3, 3) for x in d]}", flush=True)
    return missed


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
                    help="only time this source's kernels, built with each set of nvcc defines in TILES "
                         "(a process each)")
    ap.add_argument("--build", default=None,
                    help="with --tiles: only this build, 'own' (the source's defines) or a name of its TILES table")
    ap.add_argument("--w8_bench", action="store_true",
                    help="only drive the W8 decode bench path (tok/s, decode step, profile by kernel family)")
    ap.add_argument("--package_root", default=None,
                    help="import the port from this directory (another tree of the repo, such as a parent "
                         "commit unpacked with git archive), to time its kernels in the same call")
    args = ap.parse_args(argv)
    if args.build is not None and (args.tiles is None or args.build not in ["own", *TILES[args.tiles][0]]):
        ap.error(f"--build takes --tiles and one of own, {', '.join(TILES.get(args.tiles, ({},))[0])}")

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

    from vggt_qwen3_tpu_torch.ops import kernel_build

    libs = kernel_build.build(sorted(p.stem for p in kernel_build.CSRC.glob("*.cu")))
    for kl in libs:
        print(f"built {kl.name} in {kl.build_seconds:.1f} s -> {kl.path.name}", flush=True)
        for line in kl.ptxas_log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "Performance Loss")):
                print(f"  ptxas: {line.strip()}", flush=True)

    phase_done("build")
    stage = full_stage()
    if args.tiles or args.w8_bench:
        import vggt_qwen3_tpu_torch

        package = str(Path(vggt_qwen3_tpu_torch.__file__).parent)
        if args.w8_bench:
            counts, res = w8_bench_path(args)
            print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
            print(json.dumps({"w8_bench": {k: v for k, v in res.items() if k != "tokens"}, "launches": counts,
                              "package": package}), flush=True)
            return 0
        if args.build:
            times = tiles(args.tiles, args.build, stage, torch.Generator(device="cuda").manual_seed(args.seed))
        else:
            times = sweep(args.tiles, args.package_root)
        print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"tiles": args.tiles, "build": args.build or "all", "times": times, "package": package}),
              flush=True)
        return 0
    # the sources redesigned for Hopper (those TILES sweeps) build with no spill
    spilled = {kl.name: ptxas_spills(kl) for kl in libs if kl.name in TILES and ptxas_spills(kl)}
    if spilled:
        raise AssertionError(f"ptxas spills: {spilled}")
    txt = stage.model.text
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flash = flash_checks(stage, gen, args.seed)  # kernel 1 at the QA and training shapes
    attention = attention_checks(stage, gen, args.seed, args.max_new_tokens)  # kernels 2 and 3
    decode = {kv: attention[f"decode_{kv}"] for kv in ("bf16", "int8")}
    verify = {kv: attention[f"verify_{kv}"] for kv in ("bf16", "int8")}
    w8 = check_w8(txt, 368, gen)  # the W8 bench shape: 368 rows
    torch.cuda.empty_cache()
    bwd = backward_checks(stage, gen)  # kernels 8 and 9 on kernel 1's lse
    stage2_flash = stage2_flash_check(gen)  # kernel 1 at the stage-2 training run's global shape
    ring_flash = check_flash_ring(gen)  # kernel 1 at the root ring mode's 32-view shape
    phase_done("kernel checks")
    reference_check(args.seed)
    reference_check_w8(args.seed)
    reference_check_quant(args.seed)
    reference_check_speculative(args.seed)
    reference_check_slots(args.seed)
    reference_check_train(args.seed)
    phase_done("card-vs-CPU checks")
    runs = main_path(args)
    phase_done("QA path")
    w8_counts, w8_res = w8_bench_path(args)
    phase_done("W8 bench path")
    w8a8_counts = quant_path(args, w8_res)
    phase_done("W8A8/W4 and text path")
    arkit_plain, arkit_spec = arkit_path(args)
    phase_done("ARKit path")
    serve = serve_path(args, smi)
    phase_done("serving path")
    train = train_path(args)
    phase_done("training path")
    recipes = train_recipes_path(args)
    phase_done("training recipes")
    modes = bench_modes_path(args)
    phase_done("bench modes")

    f, d, d8 = flash["vggt_global"], decode["bf16"], attention["decode_w8"]
    lse = flash["train_global"]
    f2 = stage2_flash
    kernels = [
        dict(name="flash_fwd", route="cuda", source=FLASH_SOURCE,
             replaces=FLASH_REPLACES, launches=runs[None][0], **f, lse_shape=lse["shape"],
             lse_ms=lse["ms"], lse_library_ms=lse["library_ms"], lse_max_abs_err=lse["lse_max_abs_err"],
             training_launches=train["counts"]["flash_fwd"], serve_launches=serve["slots"]["flash_fwd"],
             stage2_shape=f2["shape"], stage2_ms=f2["ms"], stage2_plain_ms=f2["plain_ms"],
             stage2_library_ms=f2["library_ms"], stage2_bound_ms=f2["bound_ms"], stage2_max_abs_err=f2["max_abs_err"],
             ring_shape=ring_flash["shape"], ring_ms=ring_flash["ms"], ring_lse_ms=ring_flash["lse_ms"],
             ring_library_ms=ring_flash["library_ms"], ring_bound_ms=ring_flash["bound_ms"],
             ring_max_abs_err=ring_flash["max_abs_err"]),
        dict(name="decode_attention", route="cuda", source=ATTENTION_SOURCE, replaces=DECODE_REPLACES,
             launches=runs[None][1], **d, w8_shape=d8["shape"], w8_launches=w8_counts["decode_attention"],
             w8_ms=d8["ms"], w8_plain_ms=d8["plain_ms"], w8_library_ms=d8["library_ms"], w8_library=d8["library"],
             w8_bound_ms=d8["bound_ms"], w8_max_abs_err=d8["max_abs_err"],
             serve_launches=serve["slots"]["decode_attention"]),
        dict(name="block_verify_attention", route="cuda", source=ATTENTION_SOURCE, replaces=VERIFY_REPLACES,
             launches=arkit_spec["block_verify_attention"], **verify["bf16"],
             serve_launches=serve["spec"]["block_verify_attention"]),
    ] + [dict(name=n, route="cuda", source=W8_SOURCE, replaces=W8_REPLACES[n], launches=w8_counts[n], **w8[n],
              serve_launches=serve["slots"][n]) for n in W8_REPLACES] + [
        dict(name=n, route="cuda", source=BWD_SOURCE, replaces=BWD_REPLACES[n], launches=train["counts"][n],
             **bwd["vggt_global"][n], serve_launches=serve["slots"][n]) for n in BWD_REPLACES]
    for kr in kernels:
        not_below_bound(kr["name"], kr["ms"], kr["bound_ms"])
        kr["w8a8_bench_launches"] = w8a8_counts[kr["name"]]  # one timed W8A8 generate of quant_path
        kr["train_recipe_launches"] = recipes["recipe"]["counts"][kr["name"]]  # the bench train mode's run
        kr["stage2_launches"] = recipes["stage2"]["counts"][kr["name"]]  # the stage-2 run's 2 micro steps
        kr["bench_modes_launches"] = {m: r["counts"][kr["name"]] for m, r in modes.items()}  # each mode's run
        # each mode's first launches at each of its shapes, held to the plain version: [shapes, max_abs_err]
        kr["bench_modes_held"] = {m: [len(h), max(x["max_abs_err"] for x in h)]
                                  for m, r in modes.items() if (h := r["held"].get(kr["name"]))}
    not_below_bound("flash_fwd (stage-2 global shape)", f2["ms"], f2["bound_ms"])
    not_below_bound("decode_attention (W8 shape)", d8["ms"], d8["bound_ms"])
    print(f"int8-cache run launches: flash {runs['int8'][0]}, decode {runs['int8'][1]}", flush=True)
    print(f"ARKit plain constrained run launches: {json.dumps(arkit_plain)}", flush=True)
    print(f"serving run launches: slots {json.dumps(serve['slots'])}; speculative {json.dumps(serve['spec'])}; "
          f"batch {json.dumps(serve['batch'])}; after a prefixed admission: slots {json.dumps(serve['slots_prefix'])}, "
          f"speculative {json.dumps(serve['spec_prefix'])}", flush=True)
    print(f"training run (freeze_vision false, {2 * TRAIN_GRAD_ACCUM} micro steps) launches: "
          f"{json.dumps(train['counts'])}; a micro step: {train['per_step']}", flush=True)
    r = recipes["recipe"]
    keys = ("micro_s", "cycle_s", "update_residual_s", "step_s", "tok_s", "mfu", "peak_gib")
    print(f"training recipes: bench train mode {json.dumps({k: r[k] for k in keys})}; "
          f"stage 2 walls {recipes['stage2']['walls']}, peak {recipes['stage2']['peak_gib']:.2f} GiB; 8-bit update "
          f"card vs CPU {json.dumps(recipes['adam8bit_check'])}", flush=True)
    metrics = {m: dict(metric=r["res"]["metric"], value=r["res"]["value"], s=r["s"]) for m, r in modes.items()}
    print(f"bench modes: {json.dumps(metrics)}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s, by phase {json.dumps(phases)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
