"""vggt_qwen3_tpu_torch — the PyTorch/CUDA port of ``vggt_qwen3_tpu``.

The JAX package stays the reference; this package mirrors its module layout
and function names so each counterpart is easy to find:

- ``models/``   : Qwen3 decoder, VGGT aggregator, Perceiver projector and the
  composed VLM, as plain functions over dictionaries of tensors (the JAX
  param-tree layout, stacked ``[L, ...]`` per-layer weights included).
- ``ops/``      : norms, RoPE, sampling, preprocessing, W8 quantization and
  the kernel entry points. The kernels are hand-written CUDA C++ for Hopper
  (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` — the flash backward —,
  ``csrc/decode_attention.cu``,
  ``csrc/block_verify.cu`` — speculative block-verify attention — and
  ``csrc/decode_matmul.cu``), each with its plain PyTorch version beside its
  wrapper.
- ``inference/``: KV-cache engine (constraint FSM, per-row budgets),
  prompt-lookup speculative decoding, the action-JSON constraint tables,
  batching, and the QA and ARKit CLIs (``python -m
  vggt_qwen3_tpu_torch.inference.qa`` / ``.arkit``).
- ``train/``  : the SFT trainer (optax's AdamW, clip and accumulation in
  plain torch), losses, ``torch.save`` checkpoints and the CLI (``python -m
  vggt_qwen3_tpu_torch.train.sft``); ``data/`` holds the collator and loader.

Kernels are chosen by device: a CUDA tensor goes through the kernel (or the
wrapper raises), a CPU tensor through the plain version. Entry points default
to ``device="cuda"`` and raise when no CUDA device exists; tests pass
``device="cpu"``. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point; raises for CUDA without a card.

    There is no fallback to the CPU: a caller that wants the CPU asks for it.
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev
