"""Host libraries of the data layer, built at first use and loaded with ctypes.

``csrc/jsonl_index.cpp`` and ``csrc/image_decode.cpp`` are plain C++ with an
``extern "C"`` interface. :func:`load` compiles one with the host compiler
(``g++``, else ``c++``) into ``build/lib<name>-<hash>.so`` (the hash is of the
source and the flags, so an edited source rebuilds, as ``ops/kernel_build``
does for the CUDA kernels) and loads it. Nothing here runs at import.

A library that cannot be built (no compiler, or missing headers such as
libjpeg's) loads as None and :func:`why_not` says why; its Python module then
takes its pure-Python path, as the JAX package's does. These are host-side
readers, not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_WHY: Dict[str, str] = {}
_LOCK = threading.Lock()


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++")


def _target(name: str, link: Sequence[str]) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join([*CXX_FLAGS, *link]).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load(name: str, link: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """The loaded ``csrc/<name>.cpp`` (linked with ``link``), building it if
    needed; None where it cannot be built or loaded."""
    if name in _LIBS:
        return _LIBS[name]
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = _build(name, list(link))
    return _LIBS[name]


def _build(name: str, link: list) -> Optional[ctypes.CDLL]:
    out = _target(name, link)
    if not out.exists():
        cxx = _compiler()
        if cxx is None:
            _WHY[name] = "no host C++ compiler (g++ or c++) on PATH"
            return None
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp"), *link],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            _WHY[name] = f"{cxx} failed: {(proc.stderr or proc.stdout).strip().splitlines()[:1]}"
            return None
        os.replace(tmp, out)
    try:
        return ctypes.CDLL(str(out))
    except OSError as e:
        _WHY[name] = f"could not load {out.name}: {e}"
        return None


def why_not(name: str) -> Optional[str]:
    """Why ``csrc/<name>.cpp`` did not load (None if it loaded or was not tried)."""
    return _WHY.get(name)
