"""Thread-pooled JPEG/PNG decoding (counterpart of
``vggt_qwen3_tpu/data/image_decode.py``) over ``csrc/image_decode.cpp``, with
PIL where the native decoder is not available.

The native decoder (libjpeg / libpng, built at first use with ``-ljpeg
-lpng``, ``data/native.py``) decodes a batch of files on a C++ thread pool
with the GIL released, into preallocated numpy buffers. Its output follows
PIL's ``convert("RGB")``: PNG bit for bit (lossless, the same normalisation
of palette, gray, 16-bit and alpha), JPEG through the same libjpeg family,
where another build may differ by ±1 in a few pixels (IDCT rounding).

``native=None`` (the default) takes the native decoder when it builds and
PIL otherwise, as the JAX module does; the JAX module reads that switch from
``VGGT_NATIVE_DECODE``, this one takes it as an argument only. A file whose
format the native decoder does not sniff (BMP, GIF, …) goes to PIL; a
missing file raises ``FileNotFoundError`` either way. ``decoded`` counts the
images each backend decoded, so a caller can report which one ran.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import numpy as np

from . import native

_ERRS = {-1: "open/read failed", -2: "unsupported format", -3: "decode failed", -4: "buffer too small"}
decoded = {"native": 0, "pil": 0}


def _load() -> Optional[ctypes.CDLL]:
    lib = native.load("image_decode", link=("-ljpeg", "-lpng"))
    if lib is not None and not hasattr(lib, "_typed"):
        lib.img_probe.restype = ctypes.c_int
        lib.img_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.img_decode_rgb.restype = ctypes.c_int
        lib.img_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
        lib.img_decode_batch_rgb.restype = ctypes.c_int
        lib.img_decode_batch_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib._typed = True
    return lib


def native_available() -> bool:
    return _load() is not None


def why_not_native() -> Optional[str]:
    """Why the native decoder is not available (None when it is)."""
    return None if native_available() else native.why_not("image_decode")


def _decode_pil(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        out = np.asarray(im.convert("RGB"))
    decoded["pil"] += 1
    return out


def _probe(lib, path: str):
    """(width, height), or None for a format the native decoder does not take;
    a missing file raises."""
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.img_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc == -1 and not os.path.exists(path):
        raise FileNotFoundError(f"image not found: {path}")
    return None if rc != 0 else (w.value, h.value)


def _lib(use: Optional[bool]) -> Optional[ctypes.CDLL]:
    if use is False:
        return None
    lib = _load()
    if use and lib is None:
        raise RuntimeError(f"the native image decoder is not available: {native.why_not('image_decode')}")
    return lib


def decode_rgb(path: str, native: Optional[bool] = None) -> np.ndarray:
    """One image file → [H, W, 3] uint8 (PIL ``convert("RGB")`` semantics).
    ``native``: None takes the native decoder where it builds, True requires
    it, False uses PIL."""
    path = str(path)
    lib = _lib(native)
    if lib is None:
        return _decode_pil(path)
    dims = _probe(lib, path)
    if dims is None:
        return _decode_pil(path)
    out = np.empty((dims[1], dims[0], 3), np.uint8)
    rc = lib.img_decode_rgb(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), out.nbytes)
    if rc != 0:
        raise IOError(f"native decode of {path!r}: {_ERRS.get(rc, rc)}")
    decoded["native"] += 1
    return out


def decode_batch_rgb(paths: Sequence[str], native: Optional[bool] = None,
                     nthreads: Optional[int] = None) -> List[np.ndarray]:
    """A batch of files → [H, W, 3] uint8 arrays, decoded concurrently on the
    native decoder's thread pool (``nthreads``, default one a file up to the
    cores) when it is available."""
    paths = [str(p) for p in paths]
    lib = _lib(native)
    if lib is None or not paths:
        return [_decode_pil(p) for p in paths]
    outs: List[Optional[np.ndarray]] = [None] * len(paths)
    todo = []
    for i, p in enumerate(paths):
        dims = _probe(lib, p)
        if dims is not None:
            outs[i] = np.empty((dims[1], dims[0], 3), np.uint8)
            todo.append(i)
    if todo:
        n = len(todo)
        arr_paths = (ctypes.c_char_p * n)(*[paths[i].encode() for i in todo])
        arr_outs = (ctypes.POINTER(ctypes.c_ubyte) * n)(
            *[outs[i].ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)) for i in todo])
        arr_caps = (ctypes.c_long * n)(*[outs[i].nbytes for i in todo])
        arr_rcs = (ctypes.c_int * n)()
        lib.img_decode_batch_rgb(arr_paths, n, arr_outs, arr_caps, arr_rcs, nthreads or min(n, os.cpu_count() or 4))
        for j, i in enumerate(todo):
            if arr_rcs[j] != 0:
                raise IOError(f"native decode of {paths[i]!r}: {_ERRS.get(arr_rcs[j], arr_rcs[j])}")
        decoded["native"] += n
    for i, p in enumerate(paths):
        if outs[i] is None:  # a format the native decoder does not take
            outs[i] = _decode_pil(p)
    return outs  # type: ignore[return-value]
