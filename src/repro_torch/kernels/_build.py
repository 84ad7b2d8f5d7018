"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface.  The first
launch compiles it for Hopper (``sm_90a``) into
``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the checkout;
the hash covers the sources and the flags, so a source change rebuilds.
``nvcc`` comes from ``CUDA_HOME``, then ``PATH``, then
``/usr/local/cuda/bin``; without one the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["BUILD_DIR", "CSRC", "build", "build_log", "find_nvcc", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    candidates: List[Path] = []
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.append(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin "
        "directory on PATH to build the port's kernels"
    )


def _sources(name: str) -> List[Path]:
    main = CSRC / f"{name}.cu"
    if not main.is_file():
        raise FileNotFoundError(f"no kernel source {main}")
    return [main] + sorted(CSRC.glob("*.cuh"))


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of the current sources, or ``""`` before the first build."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the current sources are built."""
    so = _library_path(name)
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
