"""HF Qwen3 checkpoint → the port's stacked parameter tree (counterpart of
``vggt_qwen3_tpu/models/convert_qwen3.py``).

HF safetensors (or any name → tensor mapping) → the stacked ``[L, ...]``
layout of ``models/qwen3.py``, on the requested device. Every leaf goes
through float32 and is cast to ``dtype`` (round to nearest even), so the
leaves are the JAX converter's bit for bit.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch

from .. import resolve_device
from ..config import Qwen3Config
from .common import as_f32, leaf, torch_dtype

_LAYER_KEYS = {
    "ln1": ("input_layernorm.weight", False),
    "ln2": ("post_attention_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "q_norm": ("self_attn.q_norm.weight", False),
    "k_norm": ("self_attn.k_norm.weight", False),
    "gate": ("mlp.gate_proj.weight", True),
    "up": ("mlp.up_proj.weight", True),
    "down": ("mlp.down_proj.weight", True),
}


def convert_state_dict(sd: Mapping[str, object], cfg: Qwen3Config, dtype: str = "bfloat16",
                       device="cuda") -> Dict:
    """An HF ``Qwen3ForCausalLM`` state dict → the port's tree on ``device``.

    ``nn.Linear`` keeps ``weight`` as [out, in] and computes ``x @ W.T``;
    the port multiplies ``x @ w`` with ``w`` [in, out], so every linear is
    transposed. Keys are found with or without the ``model.`` prefix."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def get(name: str) -> torch.Tensor:
        key = name if name in sd else f"model.{name}"
        if key not in sd and name.startswith("model."):
            key = name[len("model."):]
        return as_f32(sd[key])

    layers = {}
    for ours, (theirs, transpose) in _LAYER_KEYS.items():
        per_layer = [get(f"model.layers.{i}.{theirs}") for i in range(cfg.num_layers)]
        layers[ours] = leaf(torch.stack([w.T if transpose else w for w in per_layer]), dt, dev)
    params = {
        "embed": leaf(get("model.embed_tokens.weight"), dt, dev),
        "final_norm": leaf(get("model.norm.weight"), dt, dev),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = leaf(get("lm_head.weight").T, dt, dev)
    return params


def load_safetensors_dir(path: str | Path) -> Dict[str, torch.Tensor]:
    """All ``*.safetensors`` shards of a directory as one flat dict of CPU
    tensors (bf16 shards included)."""
    from safetensors.torch import load_file

    path = Path(path)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files under {path}")
    out: Dict[str, torch.Tensor] = {}
    for f in files:
        out.update(load_file(str(f)))
    return out


def config_from_hf(hf_config) -> Qwen3Config:
    """The port's :class:`Qwen3Config` from a transformers ``Qwen3Config``."""
    return Qwen3Config(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=hf_config.num_key_value_heads,
        head_dim=hf_config.head_dim,
        intermediate_size=hf_config.intermediate_size,
        rope_theta=hf_config.rope_theta,
        rms_norm_eps=hf_config.rms_norm_eps,
        tie_word_embeddings=hf_config.tie_word_embeddings,
        max_position_embeddings=hf_config.max_position_embeddings,
    )


def load_qwen3(model_dir: str | Path, cfg: Optional[Qwen3Config] = None, dtype: str = "bfloat16",
               device="cuda"):
    """(cfg, params on ``device``) from a local HF model directory: its
    ``config.json`` (unless ``cfg`` is given) and its safetensors."""
    model_dir = Path(model_dir)
    if cfg is None:
        hf_raw = json.loads((model_dir / "config.json").read_text())
        cfg = Qwen3Config(
            vocab_size=hf_raw["vocab_size"],
            hidden_size=hf_raw["hidden_size"],
            num_layers=hf_raw["num_hidden_layers"],
            num_heads=hf_raw["num_attention_heads"],
            num_kv_heads=hf_raw["num_key_value_heads"],
            head_dim=hf_raw.get("head_dim", hf_raw["hidden_size"] // hf_raw["num_attention_heads"]),
            intermediate_size=hf_raw["intermediate_size"],
            rope_theta=hf_raw.get("rope_theta", 10_000.0),
            rms_norm_eps=hf_raw.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf_raw.get("tie_word_embeddings", False),
            max_position_embeddings=hf_raw.get("max_position_embeddings", 32_768),
        )
    return cfg, convert_state_dict(load_safetensors_dir(model_dir), cfg, dtype=dtype, device=device)
