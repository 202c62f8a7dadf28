"""Seeded random weights in the port's parameter layout.

The benchmark makes the weights itself, so that the program and the plain
reference start from the same values: :func:`make` draws every leaf from one
``torch.Generator`` on the device, one call a stacked leaf, directly in the
served dtype, in the order and with the distributions of the port's own
init (normal(0.02) projections and embeddings, Xavier-uniform Perceiver
linears, unit norms, LayerScale at its init value, LoRA ``A`` normal and
``B`` zero). The same seed gives the same tree, so the reference draws it
again after the window instead of holding a copy.

Layout (the port's, ``vggt_qwen3_tpu_torch/models``): ``text`` (``embed``,
``final_norm``, ``layers`` stacked ``[L, in, out]`` with a ``lora`` group),
``projector``, ``vision`` (``patch`` with its blocks, ``camera_token``,
``register_token``, ``frame_blocks``, ``global_blocks``) and ``geom``.
"""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
GEOM_FEATURES = 37  # R(9) + t(3) + K(9) + depth_hist(16)
LORA_KEYS = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
             "gate_proj": "gate", "up_proj": "up", "down_proj": "down"}


class _Draw:
    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.dev, self.dt = torch.device(device), dtype
        self.gen = None if self.dev.type == "meta" else torch.Generator(device=device).manual_seed(seed)

    def normal(self, shape, std: float = 0.02) -> torch.Tensor:
        x = torch.empty(shape, dtype=self.dt, device=self.dev)
        return x if self.gen is None else x.normal_(0.0, std, generator=self.gen)

    def xavier(self, shape) -> torch.Tensor:
        limit = (6.0 / (shape[-2] + shape[-1])) ** 0.5
        x = torch.empty(shape, dtype=self.dt, device=self.dev)
        return x if self.gen is None else x.uniform_(-limit, limit, generator=self.gen)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dt, device=self.dev)


def _text(d: _Draw, t: dict) -> dict:
    L, H, Fi = t["num_layers"], t["hidden_size"], t["intermediate_size"]
    D, NH, NKV = t["head_dim"], t["num_heads"], t["num_kv_heads"]
    return {
        "embed": d.normal((t["vocab_size"], H)),
        "final_norm": d.full((H,), 1.0),
        "layers": {
            "ln1": d.full((L, H), 1.0), "ln2": d.full((L, H), 1.0),
            "wq": d.normal((L, H, NH * D)), "wk": d.normal((L, H, NKV * D)), "wv": d.normal((L, H, NKV * D)),
            "wo": d.normal((L, NH * D, H)),
            "q_norm": d.full((L, D), 1.0), "k_norm": d.full((L, D), 1.0),
            "gate": d.normal((L, H, Fi)), "up": d.normal((L, H, Fi)), "down": d.normal((L, Fi, H)),
        },
    }


def _projector(d: _Draw, p: dict, in_dim: int, out_dim: int) -> dict:
    D, Fh, L, N = p["latent_dim"], p["ffn_dim"], p["num_layers"], p["num_latents"]
    return {
        "latents": d.normal((N, D)),
        "in_proj_w": d.xavier((in_dim, D)), "in_proj_b": d.full((D,), 0.0),
        "layers": {
            "wq": d.xavier((L, D, D)), "wk": d.xavier((L, D, D)), "wv": d.xavier((L, D, D)), "wo": d.xavier((L, D, D)),
            "bq": d.full((L, D), 0.0), "bk": d.full((L, D), 0.0), "bv": d.full((L, D), 0.0), "bo": d.full((L, D), 0.0),
            "ln1_w": d.full((L, D), 1.0), "ln1_b": d.full((L, D), 0.0),
            "ln2_w": d.full((L, D), 1.0), "ln2_b": d.full((L, D), 0.0),
            "mlp_w1": d.xavier((L, D, Fh)), "mlp_b1": d.full((L, Fh), 0.0),
            "mlp_w2": d.xavier((L, Fh, D)), "mlp_b2": d.full((L, D), 0.0),
        },
        "out_proj_w": d.xavier((D, out_dim)), "out_proj_b": d.full((out_dim,), 0.0),
    }


def _blocks(d: _Draw, L: int, E: int, mlp_ratio: float, ls: float) -> dict:
    Fh = int(E * mlp_ratio)
    return {
        "ln1_w": d.full((L, E), 1.0), "ln1_b": d.full((L, E), 0.0),
        "qkv_w": d.normal((L, E, 3 * E)), "qkv_b": d.full((L, 3 * E), 0.0),
        "proj_w": d.normal((L, E, E)), "proj_b": d.full((L, E), 0.0),
        "ls1": d.full((L, E), ls),
        "ln2_w": d.full((L, E), 1.0), "ln2_b": d.full((L, E), 0.0),
        "mlp_w1": d.normal((L, E, Fh)), "mlp_b1": d.full((L, Fh), 0.0),
        "mlp_w2": d.normal((L, Fh, E)), "mlp_b2": d.full((L, E), 0.0),
        "ls2": d.full((L, E), ls),
    }


def _vision(d: _Draw, v: dict) -> dict:
    E, R, P = v["embed_dim"], v["num_register_tokens"], v["patch_size"]
    n_side = v["img_size"] // P
    return {
        "patch": {
            "proj_w": d.normal((P, P, 3, E)), "proj_b": d.full((E,), 0.0),
            "cls": d.normal((E,)), "reg": d.normal((R, E)), "pos": d.normal((1 + n_side * n_side, E)),
            "blocks": _blocks(d, v["patch_depth"], E, v["mlp_ratio"], v["patch_ls_init"]),
            "norm_w": d.full((E,), 1.0), "norm_b": d.full((E,), 0.0),
        },
        "camera_token": d.normal((2, 1, E)),
        "register_token": d.normal((2, R, E)),
        "frame_blocks": _blocks(d, v["num_layers"], E, v["mlp_ratio"], v["agg_ls_init"]),
        "global_blocks": _blocks(d, v["num_layers"], E, v["mlp_ratio"], v["agg_ls_init"]),
    }


def _lora(d: _Draw, text: dict, t: dict, lora: dict) -> dict:
    r, L = lora["rank"], t["num_layers"]
    out = {}
    for name in lora["target_modules"]:
        key = LORA_KEYS[name]
        in_dim, out_dim = text["layers"][key].shape[-2:]
        out[key] = {"A": d.normal((L, in_dim, r)), "B": d.full((L, r, out_dim), 0.0),
                    "s": d.full((L, 1), lora["alpha"] / r)}
    return out


def make(cfg: dict, seed: int, device, *, lora: bool = False) -> Dict[str, dict]:
    """The whole tree for configuration ``cfg`` (a ``configs/*.json`` dict)
    from ``seed`` on ``device``; with ``lora`` the adapters of ``cfg["lora"]``
    under ``text/layers/lora``, drawn after every other leaf."""
    d = _Draw(seed, device, DTYPES[cfg["dtype"]])
    t, v = cfg["text"], cfg["vision"]
    text = _text(d, t)
    params = {"text": text,
              "projector": _projector(d, cfg["projector"], 2 * v["embed_dim"], t["hidden_size"]),
              "vision": _vision(d, v)}
    params["geom"] = {"w1": d.normal((GEOM_FEATURES, t["hidden_size"])), "b1": d.full((t["hidden_size"],), 0.0),
                      "w2": d.normal((t["hidden_size"], t["hidden_size"])), "b2": d.full((t["hidden_size"],), 0.0)}
    if lora:
        text["layers"]["lora"] = _lora(d, text, t, cfg["lora"])
    return params


def count(tree: dict, skip: str = "lora") -> int:
    """Elements of a tree's leaves, the ``skip`` groups left out."""
    return sum(t.numel() for name, t in leaves(tree) if skip not in name.split("/"))


def shapes(cfg: dict, *, lora: bool = False) -> Dict[str, dict]:
    """:func:`make`'s tree as meta tensors: the shapes, nothing drawn."""
    return make(cfg, 0, "meta", lora=lora)


def leaves(tree: dict, prefix: str = ""):
    """(``"a/b/c"`` path, tensor) for every leaf, in order."""
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from leaves(val, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", val
