"""Typed configuration system (the port's own copy of ``vggt_qwen3_tpu/config.py``).

Accepts the reference's stage-YAML schema (``model:``/``data:``/``train:`` keyed
dicts, see reference ``configs/stage1_3d.yaml:1-49`` and ``stage2_arkit.yaml:1-50``,
loaded by ``src/train/train_sft.py:30-32``) and resolves it into typed dataclasses.
Sub-config file indirection for the projector (``stage1_3d.yaml:7`` →
``configs/perceiver_small.yaml``) is honored, matching ``train_sft.py:67-72``.

The reference parses-but-never-uses several YAML keys (``lora:``,
``freeze_text_layers``, ``view_dropout``, ``eval_every_steps``, ``loss_heads:`` —
see SURVEY.md §5.6); we accept them without error so reference configs load
unmodified, and surface them on :class:`TrainConfig` for future use.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Qwen3Config:
    """Qwen3 dense decoder (GQA attention + QK-norm + SwiGLU MLP).

    Field values for the production preset mirror the HF config of
    ``Qwen/Qwen3-4B-Instruct-2507`` (reference model:
    ``configs/stage1_3d.yaml:2``).
    """

    vocab_size: int = 151_936
    hidden_size: int = 2_560
    num_layers: int = 36
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 9_728
    rope_theta: float = 5_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 262_144
    dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


QWEN3_4B_INSTRUCT_2507 = Qwen3Config()

# Tiny preset for CPU tests and compile-checks; same topology, small dims.
QWEN3_TINY = Qwen3Config(
    vocab_size=512,
    hidden_size=64,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    intermediate_size=128,
    rope_theta=10_000.0,
    max_position_embeddings=2_048,
)


@dataclass(frozen=True)
class VGGTConfig:
    """VGGT alternating-attention aggregator.

    The reference instantiates ``VGGT(img_size=518, patch_size=14,
    embed_dim=1024, ...)`` (``src/models/vggt_qwen3_vlm.py:72-83``) and consumes
    only ``model.aggregator(images) -> (aggregated_tokens_list, patch_start_idx)``
    whose last element has feature dim ``2 * embed_dim = 2048``
    (``vggt_qwen3_vlm.py:108-109,144-156``).

    Each of ``num_layers`` aggregator layers runs one frame-wise (within-view)
    attention block and one global (cross-view) attention block; the layer
    output exposed to consumers is the channel-concat of both block outputs.
    A camera token plus ``num_register_tokens`` register tokens are prepended
    per frame, so ``patch_start_idx = 1 + num_register_tokens``.
    """

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1_024
    num_layers: int = 24  # alternating frame/global pairs
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    layer_norm_eps: float = 1e-6
    # DINOv2 ViT-L/14 patch-feature backbone inside the aggregator.
    patch_depth: int = 24
    patch_ls_init: float = 1e-5  # DINOv2 LayerScale init
    agg_ls_init: float = 0.01  # aggregator-block LayerScale init (public VGGT)
    rope_freq: float = 100.0  # 2D rope base for aggregator blocks
    # DINOv2 interpolate_pos_encoding knobs (defaults = DINOv2 defaults):
    # offset 0.1 → scale_factor-mode bicubic with sx = (w0 + 0.1) / M;
    # torch-kernel parity (a = −0.75, no antialias) is implemented in
    # models/vggt._torch_bicubic_resize. Set offset 0.0 for size-mode.
    interpolate_offset: float = 0.1
    dtype: str = "bfloat16"

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    @property
    def out_dim(self) -> int:
        return 2 * self.embed_dim

    @property
    def patches_per_side(self) -> int:
        return self.img_size // self.patch_size


VGGT_1B = VGGTConfig()

VGGT_TINY = VGGTConfig(
    img_size=56,
    patch_size=14,
    embed_dim=32,
    num_layers=2,
    num_heads=2,
    num_register_tokens=4,
    patch_depth=2,
)


@dataclass(frozen=True)
class PerceiverConfig:
    """Perceiver resampler; defaults mirror reference
    ``configs/perceiver_small.yaml:1-6`` / ``projector_perceiver.py:20-27``."""

    latent_dim: int = 4_096
    num_latents: int = 128
    num_heads: int = 8
    num_layers: int = 6
    ffn_dim: int = 16_384
    dropout: float = 0.1
    # torch nn.LayerNorm default — the reference never overrides it.
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class VLMConfig:
    """Composition config; mirrors ``VisionLanguageConfig``
    (``src/models/vggt_qwen3_vlm.py:15-23``)."""

    text: Qwen3Config = field(default_factory=lambda: QWEN3_4B_INSTRUCT_2507)
    vision: Optional[VGGTConfig] = field(default_factory=lambda: VGGT_1B)
    projector: PerceiverConfig = field(default_factory=PerceiverConfig)
    num_vis_tokens: int = 128
    geom_tokens: int = 8
    geom_feature_dim: int = 37  # R(9)+t(3)+K(9)+depth_hist(16); vggt_qwen3_vlm.py:51
    freeze_vision: bool = True
    # "mock" emits zero tokens with the real (tokens_list, patch_start_idx)
    # tuple contract (fixes the stale mock noted in SURVEY.md §2.3).
    vision_backbone: str = "vggt"  # "vggt" | "mock"
    mock_vision_dim: int = 256  # reference mock embed_dim (vggt_qwen3_vlm.py:117)
    dtype: str = "bfloat16"

    @property
    def vision_out_dim(self) -> int:
        if self.vision_backbone == "mock" or self.vision is None:
            return self.mock_vision_dim
        return self.vision.out_dim


# ---------------------------------------------------------------------------
# Data / train configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LoRAConfig:
    """Mirrors the ``lora:`` block (``configs/stage1_3d.yaml:39-48``).

    The reference parses this and installs PEFT but never applies it —
    training there is full fine-tuning (SURVEY.md §5.6). Here LoRA is real:
    when enabled, the text model's base weights freeze and low-rank adapters
    train on the target projections.
    """

    enable: bool = False
    rank: int = 16
    alpha: int = 32
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class DataConfig:
    """Mirrors the ``data:`` block (``configs/stage1_3d.yaml:12-21``)."""

    datasets: Dict[str, str] = field(default_factory=dict)  # name -> path glob
    mix_ratio: Dict[str, float] = field(default_factory=dict)
    num_views: int = 8
    image_size: int = 448
    max_length: int = 512
    view_dropout: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors the ``train:`` block (``configs/stage1_3d.yaml:23-37``)."""

    precision: str = "bf16"
    optimizer: str = "adamw"
    lr: float = 5.0e-6
    proj_lr: Optional[float] = 1.0e-4
    weight_decay: float = 0.1
    warmup_ratio: float = 0.03
    batch_size_per_device: int = 6
    grad_accum: int = 32
    max_steps: int = 30_000
    save_every_steps: Optional[int] = 1_500
    eval_every_steps: Optional[int] = 3_000
    log_every_steps: int = 20
    gradient_clip: float = 1.0
    seed: int = 42
    # GPipe microbatches per step when mesh.pp > 1 (0 → 2·pp; utilization is
    # M/(M+pp-1), parallel/pipeline.py). The per-device batch must divide by it.
    pp_microbatches: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. Axes: ``dp`` (data), ``fsdp`` (ZeRO-3-style param
    sharding), ``tp`` (tensor parallel over ICI), ``pp`` (pipeline stages —
    GPipe schedule over the decoder stack, ``parallel/pipeline.py``). Replaces
    the reference's accelerate/DeepSpeed/NCCL layer (SURVEY.md §2.7)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.dp, self.fsdp, self.tp, self.pp)

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.pp


@dataclass(frozen=True)
class StageConfig:
    """A fully-resolved stage config (model + data + train + mesh)."""

    model: VLMConfig
    data: DataConfig
    train: TrainConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    # Freeze the bottom-N text layers (reference declares e.g. [0,1,2,3] in
    # stage1_3d.yaml:9 but never acts on it; here it masks their updates).
    freeze_text_layers: Tuple[int, ...] = ()
    # Passthrough of reference-YAML keys we accept but do not act on yet.
    extras: Dict[str, Any] = field(default_factory=dict)
    text_model_name: str = "Qwen/Qwen3-4B-Instruct-2507"
    tokenizer_path: Optional[str] = None
    vision_ckpt_dir: Optional[str] = None


# ---------------------------------------------------------------------------
# YAML loading (reference-schema compatible)
# ---------------------------------------------------------------------------


def load_yaml(path: str | Path) -> Dict[str, Any]:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def _perceiver_from(obj: Any, base_dir: Path) -> PerceiverConfig:
    if obj is None:
        return PerceiverConfig()
    if isinstance(obj, str):
        p = Path(obj)
        if not p.is_absolute() and not p.exists():
            p = base_dir / obj
        obj = load_yaml(p)
    known = {f.name for f in dataclasses.fields(PerceiverConfig)}
    return PerceiverConfig(**{k: v for k, v in obj.items() if k in known})


def load_stage_config(
    path: str | Path,
    *,
    text_config: Optional[Qwen3Config] = None,
    vision_config: Optional[VGGTConfig] = None,
    mesh: Optional[MeshConfig] = None,
) -> StageConfig:
    """Load a reference-schema stage YAML into a :class:`StageConfig`.

    ``text_config``/``vision_config`` override the production presets (used by
    tests to substitute tiny models while exercising the real YAML path).
    """

    path = Path(path)
    raw = load_yaml(path)
    mc = raw.get("model", {})
    dc = raw.get("data", {})
    tc = raw.get("train", {})

    base_dir = path.parent.parent if path.parent.name == "configs" else path.parent
    projector = _perceiver_from(mc.get("projector"), base_dir)

    vision_backbone = mc.get("vision_backbone", "vggt")
    is_mock = vision_backbone == "mock"
    model = VLMConfig(
        text=text_config or QWEN3_4B_INSTRUCT_2507,
        vision=None if is_mock else (vision_config or VGGT_1B),
        projector=projector,
        num_vis_tokens=mc.get("num_vis_tokens", 128),
        geom_tokens=mc.get("geom_tokens", 0),
        freeze_vision=mc.get("freeze_vision", True),
        vision_backbone="mock" if is_mock else "vggt",
        dtype=mc.get("dtype", "bfloat16"),
    )

    data = DataConfig(
        datasets=dict(dc.get("datasets", {})),
        mix_ratio=dict(dc.get("mix_ratio", {})),
        num_views=dc.get("num_views", 1),
        image_size=dc.get("image_size", 448),
        max_length=dc.get("max_length", 512),
        view_dropout=dc.get("view_dropout", 0.0),
    )

    train = TrainConfig(
        precision=tc.get("precision", "bf16"),
        optimizer=tc.get("optimizer", "adamw"),
        lr=float(tc.get("lr", 5.0e-6)),
        proj_lr=float(tc["proj_lr"]) if "proj_lr" in tc else None,
        weight_decay=float(tc.get("weight_decay", 0.1)),
        warmup_ratio=float(tc.get("warmup_ratio", 0.03)),
        batch_size_per_device=tc.get("batch_size_per_gpu", tc.get("batch_size_per_device", 1)),
        grad_accum=tc.get("grad_accum", 1),
        max_steps=tc.get("max_steps", 1),
        save_every_steps=tc.get("save_every_steps"),
        eval_every_steps=tc.get("eval_every_steps"),
        log_every_steps=tc.get("log_every_steps", 20),
        gradient_clip=float(tc.get("gradient_clip", 1.0)),
        seed=tc.get("seed", 42),
        pp_microbatches=int(tc.get("pp_microbatches", 0)),
    )

    if mesh is None and isinstance(raw.get("mesh"), dict):
        m = raw["mesh"]
        mesh = MeshConfig(dp=int(m.get("dp", 1)), fsdp=int(m.get("fsdp", 1)),
                          tp=int(m.get("tp", 1)), pp=int(m.get("pp", 1)))

    extras = {k: v for k, v in raw.items() if k not in ("model", "data", "train", "mesh")}
    lc = raw.get("lora") or {}
    lora = LoRAConfig(
        enable=bool(lc.get("enable", False)),
        rank=int(lc.get("rank", 16)),
        alpha=int(lc.get("alpha", 32)),
        dropout=float(lc.get("dropout", 0.05)),
        target_modules=tuple(lc.get("target_modules", ("q_proj", "k_proj", "v_proj", "o_proj"))),
    )
    return StageConfig(
        model=model,
        data=data,
        train=train,
        mesh=mesh or MeshConfig(),
        lora=lora,
        freeze_text_layers=tuple(mc.get("freeze_text_layers") or ()),
        extras=extras,
        text_model_name=mc.get("name_or_path", "Qwen/Qwen3-4B-Instruct-2507"),
        tokenizer_path=mc.get("tokenizer_path"),
        vision_ckpt_dir=vision_backbone if not is_mock else None,
    )
