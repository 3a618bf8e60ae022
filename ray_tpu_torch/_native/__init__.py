"""Native (C++) runtime components, loaded via ctypes (copy of
``ray_tpu/_native``; the library builds into ``ray_tpu_torch/_build/``).

The reference keeps its hot runtime in C++ (plasma store, raylet, core
worker); here the native layer holds the pieces that benefit from being
native on a TPU *host* — the shared-memory object arena (``arena.cc``, the
plasma equivalent). PyTorch and the CUDA kernels own device compute; this
code owns host memory.

No pybind11 in the image, so the ABI is plain C and the binding is ctypes.
The library is compiled on first use with g++ into a per-source-hash cached
.so; any failure (no compiler, exotic platform) degrades gracefully — callers
must treat ``load() is None`` as "native path unavailable" and fall back to
the pure-Python implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOAD_TRIED = False


def _build_dir() -> str:
    # beside the port's CUDA kernels, in the checkout (git-ignored), not in
    # a temp directory shared with other packages and sessions
    d = os.environ.get("RAY_TPU_NATIVE_BUILD_DIR") or os.path.join(
        os.path.dirname(_HERE), "_build"
    )
    os.makedirs(d, exist_ok=True)
    return d


def _compile(src: str, out: str) -> bool:
    cmd = [
        "g++", "-O2", "-fPIC", "-shared", "-std=c++17",
        "-o", out, src, "-lpthread", "-lrt",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0 and os.path.exists(out)


def load() -> Optional[ctypes.CDLL]:
    """Compile (once, cached by source hash) and load the native library.

    Returns None when the native path is unavailable; callers fall back.
    """
    global _LIB, _LOAD_TRIED
    if _LOAD_TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LOAD_TRIED:
            return _LIB
        _LOAD_TRIED = True
        if os.environ.get("RAY_TPU_DISABLE_NATIVE"):
            return None
        src = os.path.join(_HERE, "arena.cc")
        try:
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
        except OSError:
            return None
        out = os.path.join(_build_dir(), f"libray_tpu_arena-{digest}.so")
        if not os.path.exists(out):
            # build into a temp name + atomic rename so concurrent processes
            # never dlopen a half-written .so
            tmp = f"{out}.{os.getpid()}.tmp"
            if not _compile(src, tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return None
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            return None
        lib.rta_create.restype = ctypes.c_void_p
        lib.rta_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rta_attach.restype = ctypes.c_void_p
        lib.rta_attach.argtypes = [ctypes.c_char_p]
        lib.rta_alloc.restype = ctypes.c_uint64
        lib.rta_alloc.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.rta_pin.restype = ctypes.c_int
        lib.rta_pin.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.rta_unpin.restype = ctypes.c_int
        lib.rta_unpin.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rta_free.restype = ctypes.c_int
        lib.rta_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        for fn in ("rta_used", "rta_capacity", "rta_n_objects", "rta_segment_size"):
            getattr(lib, fn).restype = ctypes.c_uint64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.rta_base.restype = ctypes.c_void_p
        lib.rta_base.argtypes = [ctypes.c_void_p]
        lib.rta_detach.restype = None
        lib.rta_detach.argtypes = [ctypes.c_void_p]
        lib.rta_unlink.restype = ctypes.c_int
        lib.rta_unlink.argtypes = [ctypes.c_char_p]
        _LIB = lib
        return _LIB


class Arena:
    """One host-wide shared-memory arena (plasma-equivalent segment).

    The head creates it; every local worker attaches. ``alloc`` returns a
    (payload_offset, generation) pair; readers ``pin`` with that pair before
    taking zero-copy views and ``unpin`` when done — a free racing with a
    reader defers until the last unpin (see arena.cc).
    """

    def __init__(self, lib: ctypes.CDLL, handle: int, name: str, created: bool):
        self._lib = lib
        self._h = handle
        self.name = name
        self.created = created
        base = lib.rta_base(handle)
        seg = lib.rta_segment_size(handle)
        # One process-lifetime view over the whole mapping; slices of it are
        # handed to pickle as out-of-band buffers (zero copy). Payload
        # offsets from the C API are relative to the segment base.
        self._mv = memoryview((ctypes.c_ubyte * seg).from_address(base)).cast("B")

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, name: str, size: int) -> Optional["Arena"]:
        lib = load()
        if lib is None:
            return None
        h = lib.rta_create(name.encode(), size)
        if not h:
            return None
        return cls(lib, h, name, created=True)

    @classmethod
    def attach(cls, name: str) -> Optional["Arena"]:
        lib = load()
        if lib is None:
            return None
        h = lib.rta_attach(name.encode())
        if not h:
            return None
        return cls(lib, h, name, created=False)

    def unlink(self) -> None:
        self._lib.rta_unlink(self.name.encode())

    # -- allocation --------------------------------------------------------

    def alloc(self, size: int) -> Optional[tuple[int, int]]:
        gen = ctypes.c_uint64(0)
        off = self._lib.rta_alloc(self._h, size, ctypes.byref(gen))
        if off == 0:
            return None
        return off, gen.value

    def free(self, off: int, gen: int) -> int:
        return self._lib.rta_free(self._h, off, gen)

    def pin(self, off: int, gen: int) -> bool:
        return bool(self._lib.rta_pin(self._h, off, gen))

    def unpin(self, off: int) -> None:
        self._lib.rta_unpin(self._h, off)

    # -- views -------------------------------------------------------------

    def view(self, off: int, length: int) -> memoryview:
        """Zero-copy view of `length` payload bytes at `off`. Caller must
        hold a pin for as long as any derived view lives."""
        return self._mv[off : off + length]

    # -- stats -------------------------------------------------------------

    @property
    def used(self) -> int:
        return self._lib.rta_used(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.rta_capacity(self._h)

    @property
    def n_objects(self) -> int:
        return self._lib.rta_n_objects(self._h)
