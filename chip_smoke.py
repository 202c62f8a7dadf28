#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--max_new_tokens 32]

Run from the root of a checkout. It:

1. prints the card (name, ``nvidia-smi`` power limit);
2. builds both CUDA kernels of the QA path from ``vggt_qwen3_tpu_torch/csrc``
   with ``nvcc`` for sm_90a, in parallel, and prints the ptxas report;
3. holds each kernel against its plain PyTorch version at the QA path's
   shapes (``utils.agreement``, tol 2e-2 scaled to the reference: every
   element within 2e-2·max|ref| + 2e-2·|ref|, and ‖err‖₂ ≤ 5e-3·‖ref‖₂; rows
   with no valid key exactly 0), timing on the device (``torch.profiler``) the kernel, the plain
   version and one PyTorch library call that computes the same function
   (``scaled_dot_product_attention``, timed only as a yardstick — the port
   never calls it), and the wrapper's call with CUDA events (host included);
4. holds a small-width model run on the card (kernels) against the same run
   on the CPU (plain versions): prefill and first decode-step logits;
5. drives the QA path at full width — Qwen3-4B, VGGT-1B, the perceiver_small
   projector, 8 samples × 8 views × 448², random weights from ``--seed`` —
   through ``inference.qa.run_inference`` with the bf16 cache (the CLI
   default, "the main path") and with the int8 cache, with every launch
   counter set to 0 just before and read just after each run, and repeats
   each run to check the tokens are identical;
6. prints the kernels line, the card line and, last, the ok line.

Any failure raises and the script exits non-zero. Without a CUDA device, or
outside a checkout of the repo, it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
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
    library_ms = None
    if not quant:  # no single library call reads an int8 cache with folded scales
        pos = torch.arange(T, device="cuda")
        mask = (pos[None, :] >= start[:, None])[:, None, None, :]
        kl, vl, q4 = k[li], v[li], q[:, :, None]
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask, enable_gqa=True),
                               20)
    call_ms = cuda_ms(lambda: da.gqa_decode_attention(*args), iters=20)
    ms = device_ms(lambda: da.gqa_decode_attention(*args), iters=20)
    plain_ms = device_ms(lambda: da.gqa_decode_attention_plain(*args), iters=5)
    slots = sum(T - s for s in starts)
    itemsize = 1 if quant else 2
    nbytes = 2 * slots * NKV * D * itemsize + (2 * slots * NKV * 2 if quant else 0) + 2 * 2 * B * NH * D
    bms, by = bound_ms(nbytes, 4 * NH * D * slots)
    out = dict(shape=f"{name} q[{B},{NH},{D}] cache[{L},{B},{NKV},{T},{D}] li={li}",
               **agree, ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bms, bound_by=by)
    print(f"decode_attention {json.dumps(out)}", flush=True)
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


def main_path(args):
    """Full-width QA path through run_inference, bf16 then int8 cache."""
    import torch

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference import batching, engine, qa
    from vggt_qwen3_tpu_torch.models import qwen3
    from vggt_qwen3_tpu_torch.ops import decode_attention as da
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

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from vggt_qwen3_tpu_torch.data.tokenizer import load_tokenizer
    from vggt_qwen3_tpu_torch.inference.batching import max_prompt_len
    from vggt_qwen3_tpu_torch.ops import kernel_build

    libs = kernel_build.build(["flash_fwd", "decode_attention"])
    for kl in libs:
        print(f"built {kl.name} in {kl.build_seconds:.1f} s -> {kl.path.name}", flush=True)
        for line in kl.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

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
    torch.cuda.empty_cache()
    reference_check(args.seed)
    runs = main_path(args)

    f, d = flash["vggt_global"], decode["bf16"]
    kernels = [
        dict(name="flash_fwd", route="cuda", source="vggt_qwen3_tpu_torch/csrc/flash_fwd.cu",
             replaces=FLASH_REPLACES, launches=runs[None][0], **f),
        dict(name="decode_attention", route="cuda", source="vggt_qwen3_tpu_torch/csrc/decode_attention.cu",
             replaces=DECODE_REPLACES, launches=runs[None][1], **d),
    ]
    print(f"int8-cache run launches: flash {runs['int8'][0]}, decode {runs['int8'][1]}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
