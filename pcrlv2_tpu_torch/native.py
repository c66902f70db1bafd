"""ctypes bindings of the port's native data plane: the batch reader
(``csrc/pcrl_io.cpp``) and the preprocessing resampler
(``csrc/pcrl_resample.cpp``); port of ``pcrlv2_tpu/native/__init__.py``.

A C++ thread pool reads preprocessed ``.npy`` crops straight into one
preallocated float32 batch buffer: no interpreter lock on the IO path, no
per-sample allocation.  Another resamples a CT volume to 1 mm in one fused
pass.  The library is host code (no CUDA call).

At first use ``g++`` (the JAX package's ``native/Makefile`` flags) builds
both sources into ``pcrlv2_tpu_torch/_build/libpcrl_io-<digest>.so``, the
digest taken over every source and the flags, so an edited source is
rebuilt.  Concurrent
first users (test workers, several trainers) serialise on an ``flock`` and
each library is compiled to a temporary file and renamed into place, so no
process loads a half-written one.  The port never builds into or loads from
the JAX package's ``native/``.  If the build or load fails, ``get_lib``
returns None, ``build_error`` says why, and the readers and the resampler
fall back to NumPy, as the JAX package's do.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "pcrl_io.cpp"
SOURCES = (SOURCE, _PKG / "csrc" / "pcrl_resample.cpp")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
VERSION = 1


class _Library:
    """The loaded library, or why there is none; loaded once per process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tried = False
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None


_LIBRARY = _Library()


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libpcrl_io-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".pcrl_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {', '.join(s.name for s in SOURCES)}:"
                                   f"\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.pcrl_version.restype = ctypes.c_int
    lib.pcrl_version.argtypes = []
    lib.pcrl_read_npy.restype = ctypes.c_int64
    lib.pcrl_read_npy.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64]
    lib.pcrl_read_batch.restype = ctypes.c_int64
    lib.pcrl_read_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                    ctypes.c_int]
    for name, in_t in (("pcrl_resample_i16_to_xyz", ctypes.c_int16),
                       ("pcrl_resample_f32_to_xyz", ctypes.c_float)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(in_t), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_double, ctypes.c_double, ctypes.c_double,
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int]
    version = lib.pcrl_version()
    if version != VERSION:
        raise RuntimeError(f"{path.name}: pcrl_version() is {version}, expected {VERSION}")
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call; None if that failed
    (``build_error`` says why)."""
    state = _LIBRARY
    with state.lock:
        if not state.tried:
            state.tried = True
            try:
                state.lib = _bind(build())
            except (OSError, RuntimeError, subprocess.SubprocessError) as err:
                state.error = f"{type(err).__name__}: {err}"
        return state.lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library did not load (None if it did, or was not asked for)."""
    return _LIBRARY.error


def read_npy(path: str, out: np.ndarray | None = None,
             count: int | None = None) -> np.ndarray:
    """One float-convertible ``.npy`` (f32, f64, int16 or uint8) as a flat
    float32 array, read into ``out`` (or a new array of ``count`` elements,
    by default the file's size over 4, an upper bound)."""
    lib = get_lib()
    if lib is None:
        arr = np.load(path).astype(np.float32, copy=False)
        return arr.reshape(-1) if out is None else arr
    if out is None:
        if count is None:
            count = int(os.path.getsize(path) // 4)
        out = np.empty(count, np.float32)
    _check_buffer(out)
    n = lib.pcrl_read_npy(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          out.size)
    if n < 0:
        raise IOError(f"pcrl_read_npy({path}) failed with code {n}")
    return out.reshape(-1)[:n]


def read_batch(paths: Sequence[str], out: np.ndarray, n_threads: int = 8) -> np.ndarray:
    """Fill ``out`` (n_items, *item_shape), float32 and C-contiguous, from
    ``paths`` on ``n_threads`` threads.  Every file must hold exactly
    ``out[0].size`` elements; ``IOError`` names the first file that does
    not, or cannot be read.  Without the library, a NumPy loop."""
    _check_buffer(out)
    n_items = len(paths)
    if out.shape[0] != n_items:
        raise ValueError(f"{n_items} paths for a buffer of {out.shape[0]} items")
    lib = get_lib()
    if lib is None:
        for i, p in enumerate(paths):
            out[i] = np.load(p).astype(np.float32, copy=False).reshape(out.shape[1:])
        return out
    stride = out[0].size if n_items else 0
    arr = (ctypes.c_char_p * n_items)(*[p.encode() for p in paths])
    rc = lib.pcrl_read_batch(arr, n_items, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             stride, n_threads)
    if rc != 0:
        raise IOError(f"pcrl_read_batch failed on {paths[int(-rc) - 1]}")
    return out


def resample_to_xyz(arr_zyx: np.ndarray, scales_zyx: Sequence[float],
                    out_shape_zyx: Sequence[int], n_threads: int = 0) -> Optional[np.ndarray]:
    """Fused trilinear resample, float32 cast and (z, y, x) → (x, y, z)
    transpose of an int16 or float32 volume (``csrc/pcrl_resample.cpp``, the
    native stand-in for the reference's SimpleITK resampler).
    ``scales_zyx[d]`` = out_spacing / in_spacing: output voxel ``i`` samples
    input continuous index ``i·scale``, clamped.  Returns the (x, y, z)
    C-order float32 volume, or None without the library or for another
    dtype (callers take ``preprocess.mhd``'s NumPy path)."""
    if arr_zyx.ndim != 3 or len(scales_zyx) != 3 or len(out_shape_zyx) != 3 \
            or min(out_shape_zyx) < 1 or min(arr_zyx.shape) < 1:
        raise ValueError(f"resample_to_xyz: a non-empty 3-D volume to 3 positive sizes, got "
                         f"{arr_zyx.shape} → {tuple(out_shape_zyx)} with scales {scales_zyx}")
    lib = get_lib()
    if lib is None:
        return None
    if arr_zyx.dtype == np.int16:
        fn, ptr_t = lib.pcrl_resample_i16_to_xyz, ctypes.c_int16
    elif arr_zyx.dtype == np.float32:
        fn, ptr_t = lib.pcrl_resample_f32_to_xyz, ctypes.c_float
    else:
        return None
    arr_zyx = np.ascontiguousarray(arr_zyx)
    zi, yi, xi = arr_zyx.shape
    zo, yo, xo = out_shape_zyx
    out = np.empty((xo, yo, zo), np.float32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    fn(arr_zyx.ctypes.data_as(ctypes.POINTER(ptr_t)), zi, yi, xi,
       float(scales_zyx[0]), float(scales_zyx[1]), float(scales_zyx[2]),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), zo, yo, xo, n_threads)
    return out


def _check_buffer(out: np.ndarray) -> None:
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"the reader fills C-contiguous float32 buffers, got "
                         f"{out.dtype}{'' if out.flags.c_contiguous else ', not contiguous'}")
