"""Lazy JSONL access (counterpart of ``vggt_qwen3_tpu/data/jsonl_index.py``).

:class:`JsonlIndex` indexes a ``.jsonl`` file's lines once and parses a
record only when it is read. The index is the native mmap indexer of
``csrc/jsonl_index.cpp`` (built at first use, ``data/native.py``), or, where
it cannot be built or ``native=False``, the JAX module's pure-Python offset
scan. Both strip a line's trailing ``\\r`` and skip blank lines.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path
from typing import Optional

from . import native


def _load_lib() -> Optional[ctypes.CDLL]:
    lib = native.load("jsonl_index")
    if lib is not None and not hasattr(lib, "_typed"):
        lib.jsonl_open.restype = ctypes.c_void_p
        lib.jsonl_open.argtypes = [ctypes.c_char_p]
        lib.jsonl_count.restype = ctypes.c_long
        lib.jsonl_count.argtypes = [ctypes.c_void_p]
        lib.jsonl_get.restype = ctypes.c_void_p  # a raw pointer, read with string_at
        lib.jsonl_get.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
        lib.jsonl_close.restype = None
        lib.jsonl_close.argtypes = [ctypes.c_void_p]
        lib._typed = True
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class JsonlIndex:
    """O(1) random access to a JSONL file's records; each parses on demand.
    ``backend`` is ``"native"`` or ``"python"``."""

    def __init__(self, path: str | Path, *, native: Optional[bool] = None) -> None:
        self.path = Path(path)
        self._handle = None
        lib = _load_lib() if native is not False else None
        if native and lib is None:
            raise RuntimeError(f"the native JSONL indexer is not available: {_why()}")
        if lib is not None:
            handle = lib.jsonl_open(str(self.path).encode())
            if handle:
                self._lib, self._handle = lib, ctypes.c_void_p(handle)
                self._n = int(lib.jsonl_count(self._handle))
                self.backend = "native"
                return
        # the Python index (also for a file the indexer cannot map: empty or unreadable)
        data = self.path.read_bytes()
        offsets, pos = [], 0
        while pos < len(data):
            end = data.find(b"\n", pos)
            end = len(data) if end == -1 else end
            line = data[pos:end].rstrip(b"\r")
            if line.strip():
                offsets.append((pos, len(line)))
            pos = end + 1
        self._data, self._offsets, self._n = data, offsets, len(offsets)
        self.backend = "python"

    def __len__(self) -> int:
        return self._n

    def raw(self, i: int) -> bytes:
        if not 0 <= i < self._n:
            raise IndexError(i)
        if self._handle is not None:
            length = ctypes.c_long()
            ptr = self._lib.jsonl_get(self._handle, i, ctypes.byref(length))
            return ctypes.string_at(ptr, length.value)
        start, length = self._offsets[i]
        return self._data[start:start + length]

    def __getitem__(self, i: int) -> dict:
        return json.loads(self.raw(i))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.jsonl_close(self._handle)
            self._handle = None

    def __del__(self) -> None:
        self.close()


def _why() -> str:
    return native.why_not("jsonl_index") or "unknown"
