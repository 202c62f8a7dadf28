"""Decode-throughput bench of the port: the default mode of the repository's
root ``bench.py`` (the JAX package's headline), on one CUDA card.

    python -m vggt_qwen3_tpu_torch.bench [--batch 368] [--prompt 32] [--decode 128] \\
        [--quant w8|w8a8|none] [--kv int8|bf16] [--seed 0] [--device cuda] [--tiny]

Qwen3-4B with seeded random bf16 weights made on the device, quantized to W8
or W8A8 (``qwen3.quantize_params``; the root bench's ``BENCH_QUANT``); B rows of a prompt of random ids
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

The other ``BENCH_MODE``s of the root bench (e2e, qa, train, serve,
serve_sla, ring, spec) are not ported (ROADMAP).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import resolve_device
from .config import QWEN3_4B_INSTRUCT_2507, QWEN3_TINY, Qwen3Config
from .inference.engine import GenerationConfig, generate
from .models import qwen3

TIMED_RUNS = 2


@dataclasses.dataclass
class Setup:
    cfg: Qwen3Config
    params: dict
    embeds: torch.Tensor
    mask: torch.Tensor
    gen_cfg: GenerationConfig


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Decode-throughput bench of the PyTorch/CUDA port.")
    p.add_argument("--batch", type=int, default=368)
    p.add_argument("--prompt", type=int, default=32)
    p.add_argument("--decode", type=int, default=128)
    p.add_argument("--quant", choices=("w8", "w8a8", "none"), default="w8")
    p.add_argument("--kv", choices=("int8", "bf16"), default="int8")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="the tiny preset (CPU rehearsal)")
    return p.parse_args(argv)


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


def main(argv=None) -> dict:
    args = parse_args(argv)
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
