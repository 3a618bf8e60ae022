"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. On first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``ray_tpu_torch/_build/`` and loaded with ``ctypes``. The library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt. ``nvcc`` comes from ``$PATH`` or ``$CUDA_HOME/bin``; a missing
compiler or a failed build raises. The compiler's ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library
and returned by ``build_log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels are "
        "built from source at first use and need the CUDA toolkit"
    )


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the current build exists; returns
    the library path."""
    so = _library_path(name)
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name} (exit {proc.returncode}):\n{log}")
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu``'s library (once per process)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the current build of ``name``."""
    return build(name).with_suffix(".log").read_text()
