"""Tokenizer adapters (the port's own copy of ``vggt_qwen3_tpu/data/tokenizer.py``).

The reference builds its tokenizer with ``AutoTokenizer.from_pretrained(...,
use_fast=False)``, maps ``pad`` ← ``eos`` when missing, and registers an
``<image>`` token (reference ``src/train/train_sft.py:35-43`` and
``src/inference/qa_inference.py:108-116``). We reproduce exactly that surface via
:func:`load_tokenizer`, and additionally provide :class:`ByteTokenizer` — a
deterministic, dependency-free byte-level tokenizer with the same API subset —
so the framework is fully testable offline (this environment has no HF hub
egress and no cached Qwen3 tokenizer files).

Padding side is an argument to the encode helpers rather than tokenizer state:
the reference pads right for training (``train_sft.py:42``) and left for
inference (``qa_inference.py:115``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

IMAGE_TOKEN = "<image>"


class ByteTokenizer:
    """UTF-8 byte-level tokenizer with special tokens.

    ids 0..255 are raw bytes; specials are appended after. ``pad`` aliases
    ``eos`` (mirroring the reference's pad←eos fallback).
    """

    def __init__(self) -> None:
        self._specials: Dict[str, int] = {"<eos>": 256}
        self.eos_token = "<eos>"
        self.pad_token = "<eos>"

    # -- HF-compatible surface -------------------------------------------------
    @property
    def eos_token_id(self) -> int:
        return self._specials[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self._specials[self.pad_token]

    @property
    def vocab_size(self) -> int:
        return 256 + len(self._specials)

    def __len__(self) -> int:
        return self.vocab_size

    def get_vocab(self) -> Dict[str, int]:
        vocab = {f"<byte_{i}>": i for i in range(256)}
        vocab.update(self._specials)
        return vocab

    def add_tokens(self, tokens: Sequence[str]) -> int:
        added = 0
        for tok in tokens:
            if tok not in self._specials:
                self._specials[tok] = 256 + len(self._specials)
                added += 1
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._specials.get(token, -1)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """Encode text; special-token strings embedded in text (e.g. "<image>")
        are emitted as their single ids, matching HF added-token behavior."""
        ids: List[int] = []
        i = 0
        # Longest-first so overlapping specials resolve deterministically.
        specials = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            matched = False
            for sp in specials:
                if text.startswith(sp, i):
                    ids.append(self._specials[sp])
                    i += len(sp)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        if add_special_tokens:
            ids.append(self.eos_token_id)
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True, **_) -> Dict[str, List[int]]:
        ids = self.encode(text, add_special_tokens=False)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self._specials.items()}
        out: List[str] = []
        byte_run: List[int] = []

        def flush() -> None:
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for tid in ids:
            tid = int(tid)
            if tid < 256:
                byte_run.append(tid)
            else:
                flush()
                if not skip_special_tokens and tid in inv:
                    out.append(inv[tid])
        flush()
        return "".join(out)


def load_tokenizer(name_or_path: Optional[str] = None, *, add_image_token: bool = True):
    """Load an HF slow tokenizer from local files, or fall back to
    :class:`ByteTokenizer` when files are unavailable (offline environments).

    Mirrors reference ``build_tokenizer`` semantics
    (``src/train/train_sft.py:35-43``): ``use_fast=False``, pad←eos when
    missing, ``<image>`` registered when absent.
    """

    tok = None
    if name_or_path is not None:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(
                name_or_path, use_fast=False, local_files_only=True
            )
        except Exception:
            tok = None
    if tok is None:
        tok = ByteTokenizer()
    if getattr(tok, "pad_token", None) is None:
        tok.pad_token = tok.eos_token
    if add_image_token and IMAGE_TOKEN not in tok.get_vocab():
        tok.add_tokens([IMAGE_TOKEN])
    return tok


def pad_and_mask(
    seqs: Sequence[Sequence[int]],
    pad_id: int,
    *,
    min_length: int = 0,
    side: str = "right",
) -> Dict[str, List[List[int]]]:
    """Pad a ragged batch of id sequences; returns input_ids + attention_mask.

    ``side='right'`` for training, ``'left'`` for inference (reference
    ``train_sft.py:42`` vs ``qa_inference.py:115``).
    """

    max_len = max((len(s) for s in seqs), default=0)
    max_len = max(max_len, min_length)
    ids_out: List[List[int]] = []
    mask_out: List[List[int]] = []
    for s in seqs:
        pad = [pad_id] * (max_len - len(s))
        keep = [1] * len(s)
        mpad = [0] * (max_len - len(s))
        if side == "right":
            ids_out.append(list(s) + pad)
            mask_out.append(keep + mpad)
        else:
            ids_out.append(pad + list(s))
            mask_out.append(mpad + keep)
    return {"input_ids": ids_out, "attention_mask": mask_out}
