"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and compiles on
its own into ``build/lib<name>-<hash>.so`` (the hash is of the source and the
flags, so an edited source rebuilds), loaded with ``ctypes``. Nothing here runs at import:
the CPU tests import every module, and a build is reached only through a
wrapper handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class KernelLibrary:
    """A loaded kernel library plus what its build reported."""

    def __init__(self, name: str, path: Path, seconds: float, log: str):
        self.name = name
        self.path = path
        self.build_seconds = seconds
        self.ptxas_log = log
        self.lib = ctypes.CDLL(str(path))


_LIBS: Dict[str, KernelLibrary] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _flags(defines: Optional[Dict[str, int]]) -> List[str]:
    return NVCC_FLAGS + [f"-D{k}={v}" for k, v in (defines or {}).items()]


def _target(name: str, defines: Optional[Dict[str, int]] = None) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Iterable[str], defines: Optional[Dict[str, int]] = None) -> List[KernelLibrary]:
    """Compile (one ``nvcc`` per source, all started together) and load.
    ``defines`` become ``-D`` flags of every source built here.

    Raises with the compiler's output if a build fails."""
    names = list(names)
    todo = [n for n in names if n not in _LIBS]
    if not todo:  # every launch comes through here: no file system work once loaded
        return [_LIBS[n] for n in names]
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _target(n, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    # wait for every compiler before raising, so none outlives a failed build
    logs = {n: proc.communicate()[0] for n, (proc, _, _) in procs.items()}
    for n, (proc, tmp, out) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu (rc={proc.returncode}):\n{logs[n]}")
        out.with_suffix(".log").write_text(logs[n])  # what ptxas said, kept for a later load
        os.replace(tmp, out)
    seconds = time.perf_counter() - t0
    for n in todo:
        out = _target(n, defines)
        kept = out.with_suffix(".log")
        log = logs[n] if n in procs else (kept.read_text() if kept.exists() else "")
        _LIBS[n] = KernelLibrary(n, out, seconds if n in procs else 0.0, log)
    return [_LIBS[n] for n in names]


def rebuild(name: str, defines: Dict[str, int]) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` with ``defines`` (macros the source reads
    under ``#ifndef``, such as tile sizes) and load it in place of the loaded
    build: every launch through the wrappers then runs it. Empty ``defines``
    give the source's own build back."""
    src = (CSRC / f"{name}.cu").read_text()
    unread = [k for k in defines if f"#ifndef {k}\n" not in src]
    if unread:
        raise ValueError(f"{name}.cu reads no define {unread}")
    _LIBS.pop(name, None)
    return build([name], defines)[0]


def load(name: str) -> KernelLibrary:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    return build([name])[0]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero code returned by a launch: a ``cudaError_t``, or
    10000 + the ``CUresult`` of a TMA tensor map that could not be encoded."""
    if rc >= 10000:
        raise RuntimeError(f"{what} launch failed: cuTensorMapEncodeTiled returned CUresult {rc - 10000}")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")
