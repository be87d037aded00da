"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each `csrc/<name>.cu` is compiled on first use for sm_90a into a shared
library with a plain C interface under `build/torch_kernels/` at the root of
the checkout, named after a hash of its source and flags, so an edited source
rebuilds and an unchanged one loads at once. Nothing here runs at import
time: the CPU tests import every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin); the CUDA "
            "kernels are built from csrc/ on a machine with the CUDA toolkit"
        )
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    """Start nvcc for one source; the output goes to a temporary name."""
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all nvcc processes
    started together. Returns {name: compiler output} (ptxas register and
    shared-memory report) for the sources it compiled. Raises on failure."""
    names = [n for n in names if not _target(n).exists()]
    procs = {n: _start(n) for n in names}
    logs, failed = {}, []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def all_sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
