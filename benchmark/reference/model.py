"""The plain mathematics of the VGGT-1B + Perceiver + Qwen3 model, in float32.

A frozen copy for the benchmark's correctness check: it reads the weight
tree of ``benchmark/weights.py`` (the port's layout) and a configuration
dict of ``benchmark/configs``, and imports nothing of the program. Every
matrix product runs in float32 with TF32 off (:func:`strict_float32`);
attention is the textbook softmax(QKᵀ/√d)·V, computed in blocks of heads so
that it fits.

- :func:`vggt_tokens` — the VGGT aggregator: ImageNet normalisation, the
  DINOv2 patch embedding (a strided convolution) with the position table
  resized bicubically as DINOv2 resizes it, 24 DINOv2 blocks, then 24 pairs
  of frame and global blocks with 2-D RoPE; the last pair's two outputs
  concatenated. Block projections are W8A8 (``reference/quant.py``) where
  the configuration quantizes the tower, dense otherwise.
- :func:`perceiver` — the resampler (post-LN, exact-erf GELU), dropout
  masks drawn from the generator the run hands both sides, at the same
  sites in the same order (``torch.rand(x.shape) < 1 − rate``).
- :func:`geom_tokens` — the 37-feature geometry head, mean-pooled over views.
- :func:`text_hidden` / :func:`lm_loss` — Qwen3 (RMSNorm, QK-norm, rotary,
  GQA, SwiGLU) with LoRA adapters ``(x·A)·B·s``, then the tied head and the
  shifted cross-entropy over labels ≠ −100.

``Prec`` sets the precision of the products: float32, or the control's
float8 (e4m3 operands, e5m2 gradients, a scale a tensor) one step below the
bfloat16 the configurations state, with the W8A8 tower's activations in
int4, one step below its int8.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import quant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SCORE_BUDGET = 1 << 28  # float32 scores a block of attention holds (1 GiB)


def strict_float32() -> None:
    """No TF32 anywhere: float32 products stay float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _Fp8Product(torch.autograd.Function):
    """x @ w with both operands in float8 e4m3, and in the backward the
    incoming gradient in float8 e5m2 (one scale a tensor each)."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = quant.fp8(x), quant.fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = quant.fp8(g, torch.float8_e5m2)
        gx = gq @ wq.t()
        gw = (xq.reshape(-1, xq.shape[-1]).t() @ gq.reshape(-1, gq.shape[-1])).reshape(wq.shape)
        return gx, gw


class Prec:
    """The precision of the products: float32, or float8 (the control,
    whose W8A8 tower also takes its activations in int4)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8
        self.tower_act_bits = 4 if fp8 else 8

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """An operand in this precision (the gradient passes as is)."""
        x = x.float()
        if not self.fp8:
            return x
        return x + (quant.fp8(x.detach()) - x).detach()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., K] @ w [K, N]."""
        if not self.fp8:
            return x.float() @ w.float()
        return _Fp8Product.apply(x.float(), w.float())


def attention(q, k, v, *, causal: bool = False, prec: Prec = Prec()) -> torch.Tensor:
    """q [B, S, NH, D], k and v [B, T, NKV, D] → [B, S, NH, D], float32;
    NH a multiple of NKV (grouped queries)."""
    B, S, NH, D = q.shape
    T, NKV = k.shape[1], k.shape[2]
    g = NH // NKV
    qh = prec.a(q).permute(0, 2, 1, 3).reshape(B * NH, S, D)
    kh = prec.a(k).repeat_interleave(g, dim=2).permute(0, 2, 1, 3).reshape(B * NH, T, D)
    vh = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3).reshape(B * NH, T, D)
    step = max(1, SCORE_BUDGET // (S * T))
    future = torch.ones((S, T), dtype=torch.bool, device=q.device).triu(T - S + 1) if causal else None
    out = []
    for i in range(0, B * NH, step):
        s = (qh[i:i + step] @ kh[i:i + step].transpose(1, 2)) / math.sqrt(D)
        if future is not None:
            s = s.masked_fill(future, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out.append(prec.a(p) @ prec.a(vh[i:i + step].transpose(1, 2)).transpose(1, 2))
    return torch.cat(out).reshape(B, NH, S, D).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# VGGT aggregator
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w, prec: Prec) -> torch.Tensor:
    if isinstance(w, dict):
        return quant.w8a8_linear(x, w, prec.tower_act_bits)
    return prec.mm(x, w)


def _rope2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [N, T, H, D]: the first half of D rotated by the row angle, the
    second by the column angle, rotate-half pairs within each half."""
    q = x.shape[-1] // 4
    out = []
    for h, (c, s) in enumerate(((cos[..., :q], sin[..., :q]), (cos[..., q:], sin[..., q:]))):
        a, b = x[..., 2 * h * q:(2 * h + 1) * q], x[..., (2 * h + 1) * q:(2 * h + 2) * q]
        c, s = c[..., None, :], s[..., None, :]
        out += [a * c - b * s, b * c + a * s]
    return torch.cat(out, dim=-1)


def _vit_block(x, bp, heads: int, eps: float, prec: Prec, rope=None) -> torch.Tensor:
    N, T, E = x.shape
    h = F.layer_norm(x, (E,), bp["ln1_w"].float(), bp["ln1_b"].float(), eps)
    qkv = _proj(h, bp["qkv_w"], prec) + bp["qkv_b"].float()
    q, k, v = (t.reshape(N, T, heads, E // heads) for t in qkv.chunk(3, dim=-1))
    if rope is not None:
        q, k = _rope2d(q, *rope), _rope2d(k, *rope)
    a = attention(q, k, v, prec=prec).reshape(N, T, E)
    x = x + bp["ls1"].float() * (_proj(a, bp["proj_w"], prec) + bp["proj_b"].float())
    h = F.layer_norm(x, (E,), bp["ln2_w"].float(), bp["ln2_b"].float(), eps)
    h = F.gelu(_proj(h, bp["mlp_w1"], prec) + bp["mlp_b1"].float())
    return x + bp["ls2"].float() * (_proj(h, bp["mlp_w2"], prec) + bp["mlp_b2"].float())


def quantize_tower(vision: dict) -> dict:
    """The tower's four block projections as W8A8 (per layer, channel-major
    codes); everything else as it is. The dense stacks are released."""
    def blocks(bs):
        out = dict(bs)
        for key in ("qkv_w", "proj_w", "mlp_w1", "mlp_w2"):
            out[key] = [quant.channel_major(quant.w8_channels(w)) for w in bs[key]]
            bs[key] = None
        return out

    vis = dict(vision)
    vis["patch"] = dict(vis["patch"], blocks=blocks(vis["patch"]["blocks"]))
    vis["frame_blocks"] = blocks(vis["frame_blocks"])
    vis["global_blocks"] = blocks(vis["global_blocks"])
    return vis


def _rope_tables(T_special: int, hp: int, wp: int, head_dim: int, freq: float, dev):
    ys = torch.cat([torch.zeros(T_special), torch.arange(hp).repeat_interleave(wp) + 1.0]).to(dev)
    xs = torch.cat([torch.zeros(T_special), torch.arange(wp).repeat(hp) + 1.0]).to(dev)
    quarter = head_dim // 4
    inv = 1.0 / freq ** (torch.arange(quarter, dtype=torch.float32, device=dev) * 2.0 / (2 * quarter))
    ang = torch.cat([ys[:, None] * inv, xs[:, None] * inv], dim=-1)  # [T, D/2]
    return torch.cos(ang), torch.sin(ang)


@torch.no_grad()
def vggt_tokens(vis: dict, v: dict, images: torch.Tensor, prec: Prec = Prec()) -> torch.Tensor:
    """images [B, S, 3, H, W] in [0, 1] → the last pair's [B, S, T, 2E]."""
    B, S, C, H, W = images.shape
    dev = images.device
    E, R, P, heads, eps = v["embed_dim"], v["num_register_tokens"], v["patch_size"], v["num_heads"], v["layer_norm_eps"]
    mean = torch.tensor(IMAGENET_MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).reshape(1, 3, 1, 1)
    frames = (images.reshape(B * S, C, H, W).float() - mean) / std
    pp = vis["patch"]
    x = F.conv2d(frames, pp["proj_w"].float().permute(3, 2, 0, 1), pp["proj_b"].float(), stride=P)
    N, hp, wp = x.shape[0], x.shape[2], x.shape[3]
    x = x.flatten(2).transpose(1, 2)  # [N, hp·wp, E]
    M = v["img_size"] // P
    pos = pp["pos"].float()
    grid = pos[1:].reshape(1, M, M, E).permute(0, 3, 1, 2)
    off = v["interpolate_offset"]
    grid = F.interpolate(grid, scale_factor=((hp + off) / M, (wp + off) / M), mode="bicubic",
                         align_corners=False, antialias=False)
    x = x + grid.permute(0, 2, 3, 1).reshape(1, hp * wp, E)
    cls = (pp["cls"].float() + pos[0]).expand(N, 1, E)
    x = torch.cat([cls, pp["reg"].float()[None].expand(N, R, E), x], dim=1)
    for i in range(v["patch_depth"]):
        x = _vit_block(x, {k: w[i] for k, w in pp["blocks"].items()}, heads, eps, prec)
    x = F.layer_norm(x, (E,), pp["norm_w"].float(), pp["norm_b"].float(), eps)[:, 1 + R:]

    first = (torch.arange(S, device=dev) != 0).long()
    cam = vis["camera_token"].float()[first][None].expand(B, S, 1, E).reshape(N, 1, E)
    reg = vis["register_token"].float()[first][None].expand(B, S, R, E).reshape(N, R, E)
    x = torch.cat([cam, reg, x], dim=1)
    T = x.shape[1]
    cos, sin = _rope_tables(1 + R, hp, wp, E // heads, v["rope_freq"], dev)
    frame_rope = (cos[None], sin[None])
    global_rope = (cos.repeat(S, 1)[None], sin.repeat(S, 1)[None])
    for i in range(v["num_layers"]):
        x = _vit_block(x, {k: w[i] for k, w in vis["frame_blocks"].items()}, heads, eps, prec, frame_rope)
        frame_out = x
        x = _vit_block(x.reshape(B, S * T, E), {k: w[i] for k, w in vis["global_blocks"].items()}, heads, eps,
                       prec, global_rope).reshape(N, T, E)
    return torch.cat([frame_out, x], dim=-1).reshape(B, S, T, 2 * E)


# ---------------------------------------------------------------------------
# Perceiver, geometry head
# ---------------------------------------------------------------------------


def as_f32(tree: dict) -> dict:
    """A tree's leaves in float32."""
    return {k: as_f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    if gen is None or rate <= 0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=gen.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


def perceiver(pp: dict, p: dict, tokens: torch.Tensor, gen: Optional[torch.Generator], prec: Prec) -> torch.Tensor:
    """tokens [B, T, in] → [B, num_latents, out], float32."""
    B = tokens.shape[0]
    D, H, eps, rate = p["latent_dim"], p["num_heads"], p["layer_norm_eps"], p["dropout"]
    context = prec.mm(tokens, pp["in_proj_w"]) + pp["in_proj_b"]
    lat = pp["latents"][None].expand(B, -1, -1)
    lp = pp["layers"]
    for i in range(p["num_layers"]):
        q = (prec.mm(lat, lp["wq"][i]) + lp["bq"][i]).reshape(B, -1, H, D // H)
        k = (prec.mm(context, lp["wk"][i]) + lp["bk"][i]).reshape(B, -1, H, D // H)
        v = (prec.mm(context, lp["wv"][i]) + lp["bv"][i]).reshape(B, -1, H, D // H)
        a = prec.mm(attention(q, k, v, prec=prec).reshape(B, -1, D), lp["wo"][i]) + lp["bo"][i]
        lat = F.layer_norm(lat + dropout(a, rate, gen), (D,), lp["ln1_w"][i], lp["ln1_b"][i], eps)
        h = dropout(F.gelu(prec.mm(lat, lp["mlp_w1"][i]) + lp["mlp_b1"][i]), rate, gen)
        h = prec.mm(h, lp["mlp_w2"][i]) + lp["mlp_b2"][i]
        lat = F.layer_norm(lat + dropout(h, rate, gen), (D,), lp["ln2_w"][i], lp["ln2_b"][i], eps)
    return prec.mm(lat, pp["out_proj_w"]) + pp["out_proj_b"]


GEOM_KEYS = (("R", 9), ("t", 3), ("K", 9), ("depth_hist", 16))


def geom_tokens(gp: dict, geom: dict, n: int, prec: Prec) -> torch.Tensor:
    """Per-view features [B, V, k] → [B, n, H] (the view mean through
    Linear → SiLU → Linear, repeated n times)."""
    feats = torch.cat([geom[k].float() for k, _ in GEOM_KEYS], dim=-1).mean(dim=1)
    h = prec.mm(F.silu(prec.mm(feats, gp["w1"]) + gp["b1"]), gp["w2"]) + gp["b2"]
    return h[:, None, :].expand(h.shape[0], n, h.shape[-1])


# ---------------------------------------------------------------------------
# Qwen3
# ---------------------------------------------------------------------------


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim)
    f = positions.float()[..., None] * inv
    f = torch.cat([f, f], dim=-1)
    return torch.cos(f), torch.sin(f)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] (rotate-half), tables [B, S, D]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None] + rot * sin[:, :, None]


def quantize_text(text: dict, keys=("wq", "wk", "wv", "wo", "gate", "up", "down")) -> dict:
    """The Qwen3 base as W8 (every layer projection per channel, the tied
    embedding per row); norms and LoRA adapters as they are. The dense
    matrices are released."""
    layers = dict(text["layers"])
    for key in keys:
        layers[key] = w8 = quant.w8_channels(text["layers"][key])
        text["layers"][key] = None
        del w8
    out = dict(text, layers=layers, embed=quant.w8_rows(text["embed"]))
    text["embed"] = None
    return out


def _w(w, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked projection, dense float32."""
    if isinstance(w, dict):
        return w["q"][i].float() * w["s"][i].float()
    return w[i].float()


def text_layer(t: dict, lp: dict, lora: dict, i: int, h, cos, sin, prec: Prec) -> torch.Tensor:
    B, S, Hd = h.shape
    D, NH, NKV, eps = t["head_dim"], t["num_heads"], t["num_kv_heads"], t["rms_norm_eps"]

    def lin(key, x):
        y = prec.mm(x, _w(lp[key], i))
        ad = lora.get(key)
        if ad is not None:
            y = y + prec.mm(prec.mm(x, ad["A"][i]), ad["B"][i]) * ad["s"][i]
        return y

    x = rms(h, lp["ln1"][i], eps)
    q = rms(lin("wq", x).reshape(B, S, NH, D), lp["q_norm"][i], eps)
    k = rms(lin("wk", x).reshape(B, S, NKV, D), lp["k_norm"][i], eps)
    v = lin("wv", x).reshape(B, S, NKV, D)
    a = attention(rope(q, cos, sin), rope(k, cos, sin), v, causal=True, prec=prec)
    h = h + lin("wo", a.reshape(B, S, NH * D))
    x = rms(h, lp["ln2"][i], eps)
    return h + lin("down", F.silu(lin("gate", x)) * lin("up", x))


def embed_dense(text: dict) -> torch.Tensor:
    e = text["embed"]
    return quant.dense(e) if isinstance(e, dict) else e.float()


def text_hidden(text: dict, t: dict, embeds: torch.Tensor, lora: dict, prec: Prec) -> torch.Tensor:
    """embeds [B, S, H] (every position valid) → the final-norm hidden state;
    each layer recomputed in the backward."""
    B, S, _ = embeds.shape
    pos = torch.arange(S, device=embeds.device)[None].expand(B, S)
    cos, sin = rope_tables(pos, t["head_dim"], t["rope_theta"])
    h = embeds
    for i in range(t["num_layers"]):
        h = checkpoint(text_layer, t, text["layers"], lora, i, h, cos, sin, prec, use_reentrant=False)
    return rms(h, text["final_norm"], t["rms_norm_eps"])


def _nll(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, prec: Prec) -> torch.Tensor:
    logp = torch.log_softmax(prec.mm(h, head), dim=-1)
    valid = targets != -100
    nll = -torch.gather(logp, -1, torch.where(valid, targets, 0)[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum()


def lm_loss(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, prec: Prec,
            chunk: int = 512) -> torch.Tensor:
    """Mean shifted cross-entropy over labels ≠ −100; ``head`` [H, V] float32."""
    hs, targets = hidden[:, :-1], labels[:, 1:]
    total = hidden.new_zeros(())
    for c in range(0, hs.shape[1], chunk):
        total = total + checkpoint(_nll, hs[:, c:c + chunk], head, targets[:, c:c + chunk], prec,
                                   use_reentrant=False)
    return total / (targets != -100).sum().clamp_min(1)


def splice(embeds: torch.Tensor, ids: torch.Tensor, features: torch.Tensor, image_id: int) -> torch.Tensor:
    """Rows' positions from the first ``<image>`` on take the features, one
    each, as far as they reach; the length is unchanged."""
    out = embeds.clone()
    for b in range(ids.shape[0]):
        hits = (ids[b] == image_id).nonzero()
        if len(hits):
            p = int(hits[0])
            n = min(features.shape[1], ids.shape[1] - p)
            out[b, p:p + n] = features[b, :n]
    return out
