"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it is compiled
by ``nvcc`` for ``sm_90a`` into ``pcrlv2_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``.  The library's file name carries a
hash of its source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing here
runs at import time.

Also the pieces every kernel wrapper shares: the C entries' dtype suffixes,
the input checks, ctypes binding and the launch counters.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("conv3d", "conv3d_packed", "head_conv", "proto_conv", "proto_co1", "probe_mosaic")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: dtype → suffix of a kernel's C entry (``<kind>_f32``, ``<kind>_bf16``)
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: launches per kernel wrapper since the last ``launches.clear()``; each
#: wrapper adds one where it launches its kernel on the card, and nowhere else.
#: Inside ``capturing()`` the wrappers count into the graph's own counter
#: instead (a captured launch runs at each replay, not then); whoever replays
#: the graph adds that counter here once per replay.
launches: collections.Counter = collections.Counter()

_LIBS: dict = {}


@contextlib.contextmanager
def capturing():
    """Count the launches made inside into a new counter, which it yields:
    the launches a CUDA graph captures (``launches`` is rebound for the
    duration, for every thread; the wrappers read it at each call)."""
    global launches
    outer = launches
    launches = collections.Counter()
    try:
        yield launches
    finally:
        launches = outer


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every missing library in ``names``, one ``nvcc`` process per
    source, all started together.  Returns ``{name: (seconds, compiler
    output)}`` for the sources it compiled; ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel) to that output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, kind: str, dtype: torch.dtype, argtypes, restype=ctypes.c_int):
    """The C entry ``<kind>_<suffix of dtype>`` of ``csrc/<name>.cu``, bound
    with ``argtypes`` (a tuple) and ``restype`` (pass ``dtype=None`` for an
    entry without a suffix); bound once, on the first call."""
    fn = getattr(load(name), kind if dtype is None else f"{kind}_{SUFFIX[dtype]}")
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check_inputs(*tensors: torch.Tensor) -> str:
    """Validate a kernel call's tensors (one device, one kernel dtype,
    contiguous); returns the device type, ``"cpu"`` or ``"cuda"``."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dtype not in SUFFIX:
        raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise TypeError("kernel inputs must share device and dtype")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"the kernels run on cuda (or cpu), not {dev}")
    return dev.type


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, asked once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device (the
    call PyTorch's own generated code makes: a fraction of a microsecond,
    where ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream
    object each time)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
