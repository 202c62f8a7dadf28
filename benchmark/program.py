"""What the benchmark takes from the program under test
(``vggt_qwen3_tpu_torch``), in one place: its configuration objects built
from a ``configs/*.json`` dict, the launch counters its kernel wrappers
keep, and the family of a device kernel by its name.

Nothing is imported from the program when this module is imported: the
CPU tests of the manifest run without it.
"""

from __future__ import annotations

import importlib
from typing import Dict

# counter → (module, attribute): launches of each hand-written kernel
COUNTERS = {
    "flash_fwd": ("vggt_qwen3_tpu_torch.ops.flash_attention", "launches"),
    "decode_attention": ("vggt_qwen3_tpu_torch.ops.decode_attention", "launches"),
}


def counters() -> Dict[str, int]:
    """The launch counters now (those whose module is loaded)."""
    out = {}
    for name, (mod, attr) in COUNTERS.items():
        out[name] = int(getattr(importlib.import_module(mod), attr))
    return out


def family(kernel: str) -> str:
    """The breakdown's family of a device record's name (the families of
    ``chip_smoke.py``'s profiles)."""
    n = kernel.lower()
    if "flash_fwd_kernel" in n:
        return "flash_fwd"
    if "flash_bwd" in n:
        return "flash_bwd"
    if "decode_kernel" in n:
        return "decode_attention"
    if "verify_kernel" in n:
        return "block_verify_attention"
    if any(k in n for k in ("w8_gemm_kernel", "w8_swiglu_kernel", "head_argmax_kernel", "head_reduce_kernel")):
        return "w8_decode_matmul"
    if "gemm_s8" in n or "s8gemm" in n or "imma" in n:
        return "int8 cuBLASLt"
    if any(w in n for w in ("gemm", "nvjet", "sm90_", "cutlass", "cublas", "xmma", "gemv")):
        return "cuBLAS"
    if n.startswith("memcpy") or n.startswith("memset"):
        return "copies (memcpy/memset)"
    return "elementwise/norms/copies"


def stage(cfg: dict, *, rows: int):
    """The port's ``StageConfig`` of a configuration dict at ``rows`` a step."""
    from vggt_qwen3_tpu_torch.config import (DataConfig, LoRAConfig, PerceiverConfig, Qwen3Config, StageConfig,
                                             TrainConfig, VGGTConfig, VLMConfig)

    model = VLMConfig(text=Qwen3Config(**cfg["text"], dtype=cfg["dtype"]),
                      vision=VGGTConfig(**cfg["vision"], dtype=cfg["dtype"]),
                      projector=PerceiverConfig(**cfg["projector"]), num_vis_tokens=cfg["num_vis_tokens"],
                      geom_tokens=cfg["geom_tokens"], freeze_vision=cfg["freeze_vision"], dtype=cfg["dtype"])
    data = DataConfig(num_views=cfg["num_views"], image_size=cfg["image_size"], max_length=cfg["max_length"],
                      view_dropout=cfg["view_dropout"])
    train = TrainConfig(precision="bf16", optimizer=cfg["optimizer"], lr=cfg["lr"], proj_lr=cfg["proj_lr"],
                        weight_decay=cfg["weight_decay"], warmup_ratio=cfg["warmup_ratio"],
                        batch_size_per_device=rows, grad_accum=cfg["grad_accum"], max_steps=cfg["max_steps"],
                        gradient_clip=cfg["gradient_clip"])
    lora = LoRAConfig(enable=True, rank=cfg["lora"]["rank"], alpha=cfg["lora"]["alpha"],
                      target_modules=tuple(cfg["lora"]["target_modules"]))
    return StageConfig(model=model, data=data, train=train, lora=lora,
                       freeze_text_layers=tuple(cfg["freeze_text_layers"]))
