"""Convert a reference (PyTorch) VGGT-Qwen3 checkpoint into the port's
parameter tree (counterpart of the repository's
``tools/convert_reference_ckpt.py``).

Accepts any of:

- a merged reference checkpoint directory (``pytorch_model_fp32/`` with
  ``pytorch_model.bin.index.json`` and its shards, or flat
  ``*.bin`` / ``*.safetensors`` files),
- a single state-dict file,
- an HF Qwen3 model directory (the text model only).

Keys are routed by the reference's module names: ``text_model.*`` → Qwen3,
``projector.*`` → Perceiver, ``geom_head.*`` → geometry head,
``vision_model.*`` → VGGT (a bare key is taken as Qwen3's). A component the
checkpoint lacks keeps a seeded random init. The result is written as the
checkpoint ``<dest>/step_<n>/`` (``train.checkpoint.save_params``: the
parameters alone), which ``inference.qa.load_model`` restores, so
the QA CLI and the server take it with ``--checkpoint_dir <dest>``:

    python -m vggt_qwen3_tpu_torch.tools.convert_reference_ckpt \\
        --src ckpts/stage2_3d/step_30000 --dest ckpts/converted/stage2 \\
        --config configs/stage1_3d.yaml [--tiny] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

import torch

from .. import resolve_device
from ..train import checkpoint as ckpt


def load_torch_state_dict(src: Path) -> Dict:
    """Gather a full state dict from shards, flat files or a single file."""
    def torch_load(p: Path):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]
        elif isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return sd

    def load_file(f: Path):
        if f.suffix == ".safetensors":
            from safetensors.torch import load_file as load_safetensors

            return load_safetensors(str(f))
        return torch_load(f)

    if src.is_file():
        return load_file(src)
    for sub in (src / "pytorch_model_fp32", src / "pytorch_model_fp32.bin", src):
        index = sub / "pytorch_model.bin.index.json"
        if sub.is_dir() and index.exists():
            weight_map = json.loads(index.read_text())["weight_map"]
            state: Dict = {}
            for shard in sorted(set(weight_map.values())):
                state.update(torch_load(sub / shard))
            return state
    for sub in (src / "pytorch_model_fp32", src):
        if sub.is_dir():
            files = sorted(sub.glob("*.safetensors")) or sorted(sub.glob("*.bin"))
            if files:
                state = {}
                for f in files:
                    state.update(load_file(f))
                return state
    raise FileNotFoundError(f"no checkpoint weights found under {src}")


def split_by_prefix(sd: Dict) -> Dict[str, Dict]:
    groups: Dict[str, Dict] = {"text": {}, "projector": {}, "geom": {}, "vision": {}}
    for key, val in sd.items():
        k = key.removeprefix("module.")
        if k.startswith("text_model."):
            groups["text"][k.removeprefix("text_model.")] = val
        elif k.startswith("projector."):
            groups["projector"][k.removeprefix("projector.")] = val
        elif k.startswith("geom_head."):
            groups["geom"][k.removeprefix("geom_head.")] = val
        elif k.startswith("vision_model."):
            groups["vision"][k.removeprefix("vision_model.")] = val
        else:
            groups["text"][k] = val  # bare HF Qwen3 checkpoints
    return groups


def convert(src: Path, stage, dtype: str, device="cuda", seed: int = 0) -> Dict:
    """The checkpoint at ``src`` as the port's parameter tree on ``device``;
    components it lacks keep ``vlm.init_params`` from a generator seeded
    with ``seed`` (the reference loads with ``strict=False`` for the same
    reason)."""
    from ..models import geom as geom_mod
    from ..models import perceiver, vggt, vlm
    from ..models.convert_qwen3 import convert_state_dict

    dev = resolve_device(device)
    groups = split_by_prefix(load_torch_state_dict(Path(src)))
    print({k: len(v) for k, v in groups.items()}, flush=True)
    params = vlm.init_params(torch.Generator(device=dev).manual_seed(seed), stage.model, dtype=dtype)
    if groups["text"]:
        params["text"] = convert_state_dict(groups["text"], stage.model.text, dtype=dtype, device=dev)
        print("text model converted", flush=True)
    if groups["projector"]:
        params["projector"] = perceiver.convert_torch_state_dict(groups["projector"], stage.model.projector,
                                                                 dtype=dtype, device=dev)
        print("projector converted", flush=True)
    if groups["geom"]:
        params["geom"] = geom_mod.convert_torch_state_dict(groups["geom"], dtype=dtype, device=dev)
        print("geometry head converted", flush=True)
    if groups["vision"] and stage.model.vision is not None:
        params["vision"] = vggt.convert_torch_state_dict(groups["vision"], stage.model.vision, dtype=dtype,
                                                         device=dev)
        print("vision tower converted", flush=True)
    return params


def save_params(params: Dict, dest: Path, step: int) -> Path:
    """``<dest>/step_<step>/``, the parameter tree in ``train.checkpoint``'s
    format (written into a ``.tmp`` directory and renamed when complete)."""
    path = Path(dest) / f"step_{step}"
    ckpt.save_params(params, path)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Reference checkpoint → the port's params (a step_<n> checkpoint).")
    ap.add_argument("--src", type=Path, required=True)
    ap.add_argument("--dest", type=Path, required=True)
    ap.add_argument("--config", default="configs/stage1_3d.yaml")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--step", type=int, default=0, help="the step directory's number")
    ap.add_argument("--tiny", action="store_true", help="tiny configs (tests)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..config import QWEN3_TINY, VGGT_TINY, load_stage_config

    stage = load_stage_config(args.config, text_config=QWEN3_TINY if args.tiny else None,
                              vision_config=VGGT_TINY if args.tiny else None)
    params = convert(args.src, stage, args.dtype, device=args.device)
    path = save_params(params, args.dest, args.step)
    print(f"saved {path}", flush=True)


if __name__ == "__main__":
    main()
