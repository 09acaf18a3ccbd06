"""ctypes bindings of the C++ prefetching scan loader (port of
``scl_slam_tpu/io/native_loader.py``).

``csrc/dataloader.cpp`` reads velodyne ``.bin`` files with a worker pool
into fixed-capacity padded host buffers and hands them over in order, so
disk reads overlap the device's work. It is compiled with ``g++`` at first
use into ``_build/`` (gitignored), under a name that hashes the source and
the flags, and loaded with ``ctypes``. Where it cannot be built, the loader
raises: there is no silent fall back to the Python reader
(``io/kitti.read_velodyne_bin``), which the caller picks instead
(``run --loader python``).

The JAX module's ``sc_images_batch`` (Scan Context binning on the host)
is not carried (ROADMAP, "Not carried").
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dataloader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lib = None
_lib_lock = threading.Lock()
# seconds the last build took (0.0 when the library was already there)
last_build_s = 0.0


def build() -> Path:
    """Compile the loader unless a library of the same source and flags is
    in ``_build/``; returns its path. Raises RuntimeError with the
    compiler's output when there is no compiler or the build fails."""
    global last_build_s
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libscl_loader_{h.hexdigest()[:16]}.so"
    if lib.exists():
        last_build_s = 0.0
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("native loader: no C++ compiler (g++) to build it with")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built under a name of its own, then renamed: concurrent builds (test
    # workers, ranks) never load a half-written library
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    r = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader: the build failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib)
    last_build_s = time.perf_counter() - t0
    return lib


def load_library():
    """The loader library (built at first use). Raises where it cannot be
    built."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.loader_capacity.restype = ctypes.c_int
        lib.loader_capacity.argtypes = [ctypes.c_void_p]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeScanLoader:
    """In-order prefetching reader over a list of ``.bin`` paths.

    Yields (xyz [capacity, 3] float32 padded with ``pad_value``, n_valid);
    a file longer than ``capacity`` points is truncated. ``workers``
    threads read ahead of the consumer, at most ``queue_depth`` scans.
    Raises IOError on a file that cannot be read.
    """

    def __init__(
        self,
        paths: list[str],
        capacity: int = 131072,
        pad_value: float = 1e6,
        workers: int = 2,
        queue_depth: int = 4,
    ):
        self._lib = load_library()
        self.capacity = capacity
        arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        self._handle = self._lib.loader_create(
            arr, len(paths), capacity, pad_value, workers, queue_depth
        )

    def __iter__(self):
        buf = np.empty((self.capacity, 3), np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        while True:
            n = self._lib.loader_next(self._handle, ptr)
            if n == -2:
                return
            if n < 0:
                raise IOError("native loader: a scan could not be read")
            yield buf.copy(), n

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
