"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a step,
and the least time each hand-written kernel could take at a shape.

Peaks are NVIDIA's published dense figures for one H100 SXM at its 700 W
limit: 989 TFLOP/s in bfloat16 and 3.35 TB/s of HBM. A roofline bound is
the larger of the operations over the FLOP rate and the bytes over the
bandwidth, each input read once and each output written once; attention
counts ``4·B·H·S_q·S_k·D`` operations, halved where causal (the rule of
PERF.md's kernel table, without its exponential floor).

Model FLOPs count the work a step needs, not what the program happens to
run: ``2·N·tokens`` for every matrix product of a forward, plus attention.
A frozen tower runs its forward only; a frozen base under LoRA takes the
gradients of its activations (another ``2·N·tokens``) and none of its
weights; the adapters, the projector and the geometry head take both
(``6·N·tokens``); recomputation is not counted.
"""

from __future__ import annotations

from typing import List, Tuple

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12
BF16 = 2

Shape = Tuple[int, int, int, int]  # [B, S, H, D]


def attention_flops(B: int, H: int, Sq: int, Sk: int, D: int, causal: bool = False) -> float:
    f = 4.0 * B * H * Sq * Sk * D
    return f / 2 if causal else f


def roofline_s(flops: float, nbytes: float) -> float:
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S)


def flash_fwd_bound_s(shape: Shape, causal: bool = False, kv_heads: int = 0, lse: bool = False) -> float:
    """Kernel 1 (``csrc/flash_fwd.cu``) at q ``[B, S, H, D]`` bf16 over K/V
    of the same length with ``kv_heads`` heads (default H): Q, K, V read and
    O written once (and an f32 log-sum-exp row a query with ``lse``)."""
    B, S, H, D = shape
    kvh = kv_heads or H
    nbytes = BF16 * B * S * D * (2 * H + 2 * kvh) + (4 * B * H * S if lse else 0)
    return roofline_s(attention_flops(B, H, S, S, D, causal), nbytes)


def decode_attention_bound_s(B: int, NH: int, NKV: int, T: int, D: int, kv_bytes: int = BF16,
                             scale_bytes: int = 0) -> float:
    """Kernel 2 (``csrc/decode_attention.cu``): one query a row over ``T``
    valid cached positions of ``NKV`` heads: K and V (and their per-position
    scales for an int8 cache) read once, q read and the output written once."""
    nbytes = B * NKV * T * (2 * D * kv_bytes + 2 * scale_bytes) + 2 * BF16 * B * NH * D
    return roofline_s(attention_flops(B, NH, 1, T, D), nbytes)


# ---------------------------------------------------------------------------
# the model's sizes
# ---------------------------------------------------------------------------


def vision_tokens_per_view(v: dict, image_size: int) -> int:
    return 1 + v["num_register_tokens"] + (image_size // v["patch_size"]) ** 2


def vision_block_params(v: dict) -> int:
    E = v["embed_dim"]
    Fh = int(E * v["mlp_ratio"])
    return 3 * E * E + E * E + 2 * E * Fh


def text_layer_params(t: dict) -> int:
    H, F = t["hidden_size"], t["intermediate_size"]
    q, kv = t["num_heads"] * t["head_dim"], t["num_kv_heads"] * t["head_dim"]
    return H * q + 2 * H * kv + q * H + 3 * H * F


def lora_params(cfg: dict) -> int:
    t, r = cfg["text"], cfg["lora"]["rank"]
    H, q, kv = t["hidden_size"], t["num_heads"] * t["head_dim"], t["num_kv_heads"] * t["head_dim"]
    dims = {"q_proj": (H, q), "k_proj": (H, kv), "v_proj": (H, kv), "o_proj": (q, H)}
    return t["num_layers"] * sum(r * (dims[m][0] + dims[m][1]) for m in cfg["lora"]["target_modules"])


def vision_forward_flops(cfg: dict, frames: int, views: int, image_size: int) -> float:
    """The tower over ``frames`` = rows·views images: the patch embedding,
    every block's products, frame attention over each view's tokens and
    global attention over each row's ``views`` views."""
    v = cfg["vision"]
    T = vision_tokens_per_view(v, image_size)
    E, H, P = v["embed_dim"], v["num_heads"], v["patch_size"]
    D = E // H
    patches = (image_size // P) ** 2
    n_blocks = v["patch_depth"] + 2 * v["num_layers"]
    f = 2.0 * frames * patches * (3 * P * P) * E
    f += 2.0 * vision_block_params(v) * n_blocks * frames * T
    f += (v["patch_depth"] + v["num_layers"]) * attention_flops(frames, H, T, T, D)
    rows = frames // views
    f += v["num_layers"] * attention_flops(rows, H, views * T, views * T, D)
    return f


def perceiver_forward_flops(cfg: dict, rows: int) -> float:
    p, v, t = cfg["projector"], cfg["vision"], cfg["text"]
    D, Fh, N, C = p["latent_dim"], p["ffn_dim"], p["num_latents"], cfg["num_vis_tokens"]
    f = 2.0 * rows * C * (2 * v["embed_dim"]) * D
    per_layer = 2.0 * rows * (N * D * D * 2 + C * D * D * 2 + N * 2 * D * Fh)
    per_layer += attention_flops(rows, p["num_heads"], N, C, D // p["num_heads"])
    f += p["num_layers"] * per_layer
    return f + 2.0 * rows * N * D * t["hidden_size"]


def text_forward_flops(cfg: dict, rows: int, length: int, *, head: bool = True) -> float:
    """The Qwen3 stack over ``rows`` × ``length`` tokens, causal attention,
    the tied head over every position when ``head``."""
    t = cfg["text"]
    tokens = rows * length
    f = 2.0 * t["num_layers"] * text_layer_params(t) * tokens
    f += t["num_layers"] * attention_flops(rows, t["num_heads"], length, length, t["head_dim"], causal=True)
    if head:
        f += 2.0 * t["vocab_size"] * t["hidden_size"] * tokens
    return f


def train_step_flops(cfg: dict, rows: int) -> float:
    """One micro step of a QLoRA training cell (module note): the frozen
    tower's forward; the Perceiver, the geometry head and the adapters at
    three times their forward; the frozen base and head at twice theirs."""
    views, size, T = cfg["num_views"], cfg["image_size"], cfg["max_length"]
    t = cfg["text"]
    f = vision_forward_flops(cfg, rows * views, views, size)
    f += 3 * perceiver_forward_flops(cfg, rows)
    f += 3 * 2.0 * rows * (37 * t["hidden_size"] + t["hidden_size"] ** 2)
    f += 2 * text_forward_flops(cfg, rows, T)
    f += t["num_layers"] * attention_flops(rows, t["num_heads"], T, T, t["head_dim"], causal=True)  # dq, dk, dv
    f += 3 * 2.0 * lora_params(cfg) * rows * T
    return f


def root_bench_train_flops(cfg: dict, rows: int, n_vis: int, n_text: int, n_proj: int) -> float:
    """The port's ``bench.train_flops`` for the same step, kept for
    comparison only: 2·N_vis·vision tokens + 6·N_text·text tokens +
    6·N_proj·rows·latents, with N each tree's weights (``weights.count``;
    the text without its adapters)."""
    vis_tokens = rows * cfg["num_views"] * vision_tokens_per_view(cfg["vision"], cfg["image_size"])
    return (2.0 * n_vis * vis_tokens + 6.0 * n_text * rows * cfg["max_length"]
            + 6.0 * n_proj * rows * cfg["projector"]["num_latents"])


def train_flash_launches(cfg: dict, rows: int) -> List[Tuple[Shape, bool]]:
    """Kernel 1's launches in one micro step of a frozen-tower training cell,
    (shape, causal): the DINOv2 and frame blocks over each view, the global
    blocks over each row's views. The text stack trains through plain
    attention."""
    v = cfg["vision"]
    T = vision_tokens_per_view(v, cfg["image_size"])
    E, H, V = v["embed_dim"], v["num_heads"], cfg["num_views"]
    frame = ((rows * V, T, H, E // H), False)
    glob = ((rows, V * T, H, E // H), False)
    return [frame] * (v["patch_depth"] + v["num_layers"]) + [glob] * v["num_layers"]


def qa_flash_launches(cfg: dict, rows: int, width: int) -> List[Tuple[Shape, bool]]:
    """Kernel 1's launches in one QA batch: the tower's (as in training, over
    ``rows`` samples) and the prefill's, one a layer over the spliced prompt
    (``width`` positions, causal)."""
    t = cfg["text"]
    prefill = ((rows, width, t["num_heads"], t["head_dim"]), True)
    return train_flash_launches(cfg, rows) + [prefill] * t["num_layers"]


def qa_flash_bound_s(cfg: dict, valid: List[int]) -> float:
    """The bound of kernel 1's launches in one QA batch: the tower's, and the
    prefill's over each row's ``valid`` positions (its left padding needs no
    work), Q, K, V read and O written once."""
    t = cfg["text"]
    NH, NKV, D = t["num_heads"], t["num_kv_heads"], t["head_dim"]
    tower = sum(flash_fwd_bound_s(s, c) for s, c in train_flash_launches(cfg, len(valid)))
    flops = sum(attention_flops(1, NH, n, n, D, causal=True) for n in valid)
    nbytes = sum(BF16 * n * D * (2 * NH + 2 * NKV) for n in valid)
    return tower + t["num_layers"] * roofline_s(flops, nbytes)


def qa_decode_bound_s(cfg: dict, valid: List[int], steps: int) -> float:
    """The bound of kernel 2's launches in one QA batch: a launch a layer a
    decode step, step ``s`` reading each row's ``valid + s + 1`` cached
    positions (bf16 K and V) once."""
    t = cfg["text"]
    NH, NKV, D = t["num_heads"], t["num_kv_heads"], t["head_dim"]
    total = 0.0
    for s in range(steps):
        flops = sum(attention_flops(1, NH, 1, n + s + 1, D) for n in valid)
        nbytes = sum(NKV * (n + s + 1) * 2 * D * BF16 + 2 * BF16 * NH * D for n in valid)
        total += roofline_s(flops, nbytes)
    return t["num_layers"] * total


def qa_batch_flops(cfg: dict, valid: List[int], steps: int) -> float:
    """Model FLOPs of one QA batch: the tower and the Perceiver over every
    sample, the prefill over each row's valid positions with the head at the
    last, and ``steps`` decode steps, each a token a row through every
    layer and the head, attending to the row's cache."""
    t = cfg["text"]
    rows = len(valid)
    N, head = t["num_layers"] * text_layer_params(t), t["vocab_size"] * t["hidden_size"]
    NH, D = t["num_heads"], t["head_dim"]
    f = vision_forward_flops(cfg, rows * cfg["num_views"], cfg["num_views"], cfg["image_size"])
    f += perceiver_forward_flops(cfg, rows)
    f += sum(2.0 * N * n + t["num_layers"] * attention_flops(1, NH, n, n, D, causal=True) + 2.0 * head
             for n in valid)
    for s in range(steps):
        f += sum(2.0 * N + 2.0 * head + t["num_layers"] * attention_flops(1, NH, 1, n + s + 1, D) for n in valid)
    return f
