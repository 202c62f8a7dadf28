#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--max_new_tokens 32]

Run from the root of a checkout. It:

1. prints the card (name, ``nvidia-smi`` power limit);
2. builds the four CUDA sources of the port from ``vggt_qwen3_tpu_torch/csrc``
   (flash forward, decode attention, block-verify attention, the four W8
   decode kernels) with ``nvcc`` for sm_90a, in parallel, and prints the
   ptxas report;
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
   every slot no query sees;
4. holds small-width models run on the card (kernels) against the same runs
   on the CPU (plain versions): bf16; W8 with an int8 cache; and
   speculative decoding under the action-JSON constraint with an int8 cache
   (tokens equal on every row whose every step has a top-2 gap above
   1e-4·max|logit|);
5. drives the QA path at full width — Qwen3-4B, VGGT-1B, the perceiver_small
   projector, 8 samples × 8 views × 448², random weights from ``--seed`` —
   through ``inference.qa.run_inference`` with the bf16 cache (the CLI
   default, "the main path") and with the int8 cache, with every launch
   counter set to 0 just before and read just after each run, and repeats
   each run to check the tokens are identical; then once with W8 weights
   (``quantize=True``);
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
8. prints the kernels line, the card line and, last, the ok line.

Any failure raises and the script exits non-zero. Without a CUDA device, or
outside a checkout of the repo, it exits non-zero before printing a result.
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
FLASH_REPLACES = "vggt_qwen3_tpu/ops/flash_attention.py:41"
DECODE_REPLACES = "vggt_qwen3_tpu/ops/decode_attention.py:55"
VERIFY_REPLACES = "vggt_qwen3_tpu/ops/decode_attention.py:317"
ARKIT_SCENES = "data/processed/arkit_synth/test.json"
SCHEMA_KEYS = ["action", "scene", "center", "normal", "extent"]
DRAFT_K = 6  # generate_batch's default verify block: k + 1 = 7 queries
ARKIT_NEW_TOKENS = 340  # every constrained object closes within 340 byte tokens
ARKIT_PROFILE_TOKENS = 128
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


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' durations as
    ``torch.profiler`` records them, over ``iters`` calls. Unlike
    :func:`cuda_ms` it leaves out the host's time between launches, which is
    what a back-to-back loop of a short kernel measures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / iters


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


def check_w8(cfg, M: int, gen) -> dict:
    """The four W8 decode kernels at the bench shape (``cfg`` = Qwen3-4B,
    M = 368 rows), each against its plain version, timed with the layer
    index turning over the layers; the yardstick is ``torch.mm`` over a bf16
    copy dequantized outside the timed region."""
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
    xm = (x * 0.05).contiguous()  # the MLP's input: outputs of the order of one
    li = L - 1
    turn = layer_turns(L)
    out = {}

    def measure(name, kernel, plain, library, flops, nbytes, compare):
        got, ref = kernel(li), plain(li)
        torch.cuda.synchronize()
        agree = compare(got, ref)
        res = dict(**agree, ms=device_ms(lambda: kernel(turn()), iters=2 * L),
                   call_ms=cuda_ms(lambda: kernel(turn()), iters=2 * L),
                   plain_ms=device_ms(lambda: plain(turn()), iters=4),
                   library_ms=device_ms(lambda: library(turn()), iters=2 * L))
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
        res["shape"] = f"M={M} " + name
        print(f"{name.split()[0]} {json.dumps(res)}", flush=True)
        return res

    def held(name):
        return lambda got, ref: held_to_plain(name, torch.cat([g.flatten() for g in got]),
                                              torch.cat([r.flatten() for r in ref]))

    w_qkv = torch.cat([quant.dequantize(w[k]) for k in ("wq", "wk", "wv")], dim=-1)
    out["fused_qkv_w8"] = measure(
        f"fused_qkv_w8 x[{M},{H}] wq|wk|wv[{L},{H},{NQ}+{NKV}+{NKV}]",
        lambda i: dm.fused_qkv_w8(x, w["wq"], w["wk"], w["wv"], i),
        lambda i: dm.fused_qkv_w8_plain(x, w["wq"], w["wk"], w["wv"], i),
        lambda i: torch.mm(x, w_qkv[i]),
        2 * M * H * (NQ + 2 * NKV), H * (NQ + 2 * NKV) + 2 * (NQ + 2 * NKV) + 2 * M * H + 2 * M * (NQ + 2 * NKV),
        held("fused_qkv_w8"))
    del w_qkv
    w_o = quant.dequantize(w["wo"])
    out["fused_linear_w8"] = measure(
        f"fused_linear_w8 a[{M},{NQ}] wo[{L},{NQ},{H}]",
        lambda i: (dm.fused_linear_w8(a, w["wo"], i),),
        lambda i: (dm.fused_linear_w8_plain(a, w["wo"], i),),
        lambda i: torch.mm(a, w_o[i]),
        2 * M * NQ * H, NQ * H + 2 * H + 2 * M * NQ + 2 * M * H, held("fused_linear_w8"))
    del w_o
    w_gu = torch.cat([quant.dequantize(w["gate"]), quant.dequantize(w["up"])], dim=-1)
    w_d = quant.dequantize(w["down"])

    def mlp_library(i):
        gu = torch.mm(xm, w_gu[i])
        return torch.mm(F.silu(gu[:, :Fd]) * gu[:, Fd:], w_d[i])

    out["fused_mlp_w8"] = measure(
        f"fused_mlp_w8 x[{M},{H}] gate/up[{L},{H},{Fd}] down[{L},{Fd},{H}]",
        lambda i: (dm.fused_mlp_w8(xm, w["gate"], w["up"], w["down"], i),),
        lambda i: (dm.fused_mlp_w8_plain(xm, w["gate"], w["up"], w["down"], i),),
        mlp_library, 6 * M * H * Fd, 3 * H * Fd + 2 * (2 * Fd + H) + 2 * M * H + 2 * M * H, held("fused_mlp_w8"))
    del w_gu, w_d, w

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


def profile_breakdown(label: str, run, unprofiled_s: float):
    """One more run of a main-path phase under torch.profiler: device time by
    kernel family and by kernel. The profiler slows the host, so the idle
    share is also given against ``unprofiled_s``, the same run's wall time
    without it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if busy <= 0:
        print(f"profile {label}: the profiler saw no device time", flush=True)
        return

    def family(name):
        n = name.lower()
        if "flash_fwd_kernel" in n:
            return "flash_fwd (ours)"
        if "decode_kernel" in n:
            return "decode_attention (ours)"
        if "verify_kernel" in n:
            return "block_verify_attention (ours)"
        if "w8_gemm_kernel" in n or "w8_swiglu_kernel" in n:
            return "W8 GEMMs: qkv, wo, mlp (ours)"
        if "head_tile_kernel" in n or "head_reduce_kernel" in n:
            return "head_argmax (ours)"
        if any(w in n for w in ("gemm", "nvjet", "sm90_", "cutlass", "cublas", "xmma", "gemv")):
            return "matmul (cuBLAS)"
        return "other (elementwise, norms, copies, reductions)"

    fam = {}
    for n, us in by_name.items():
        fam[family(n)] = fam.get(family(n), 0.0) + us
    print(f"profile {label}: device busy {busy / 1e6:.3f} s; wall {wall_us / 1e6:.3f} s profiled "
          f"(idle share {max(0.0, 1 - busy / wall_us):.3f}), {unprofiled_s:.3f} s unprofiled "
          f"(idle share {max(0.0, 1 - busy / 1e6 / unprofiled_s):.3f})", flush=True)
    for f_name, us in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"profile {label} family: {f_name}: {us / 1e3:.1f} ms ({us / busy:.3f})", flush=True)
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile {label} kernel: {n[:90]}: {us / 1e3:.1f} ms ({us / busy:.3f})", flush=True)


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
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "vggt_qwen3_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
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

    libs = kernel_build.build(["flash_fwd", "decode_attention", "block_verify", "decode_matmul"])
    for kl in libs:
        print(f"built {kl.name} in {kl.build_seconds:.1f} s -> {kl.path.name}", flush=True)
        for line in kl.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    phase_done("build")
    # main-path shapes: 8 prompts, left-padded, 128 vision tokens spliced in
    stage = full_stage()
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
    phase_done("kernel checks")
    reference_check(args.seed)
    reference_check_w8(args.seed)
    reference_check_speculative(args.seed)
    phase_done("card-vs-CPU checks")
    runs = main_path(args)
    phase_done("QA path")
    w8_counts, _ = w8_bench_path(args)
    phase_done("W8 bench path")
    arkit_plain, arkit_spec = arkit_path(args)
    phase_done("ARKit path")

    f, d = flash["vggt_global"], decode["bf16"]
    kernels = [
        dict(name="flash_fwd", route="cuda", source="vggt_qwen3_tpu_torch/csrc/flash_fwd.cu",
             replaces=FLASH_REPLACES, launches=runs[None][0], **f),
        dict(name="decode_attention", route="cuda", source="vggt_qwen3_tpu_torch/csrc/decode_attention.cu",
             replaces=DECODE_REPLACES, launches=runs[None][1], **d),
        dict(name="block_verify_attention", route="cuda", source="vggt_qwen3_tpu_torch/csrc/block_verify.cu",
             replaces=VERIFY_REPLACES, launches=arkit_spec["block_verify_attention"], **verify["bf16"]),
    ] + [dict(name=n, route="cuda", source=W8_SOURCE, replaces=W8_REPLACES[n], launches=w8_counts[n], **w8[n])
         for n in W8_REPLACES]
    print(f"int8-cache run launches: flash {runs['int8'][0]}, decode {runs['int8'][1]}", flush=True)
    print(f"ARKit plain constrained run launches: {json.dumps(arkit_plain)}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s, by phase {json.dumps(phases)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
