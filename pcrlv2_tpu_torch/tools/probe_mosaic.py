"""Kernel #10: the 14 data-movement and dot probes on the GPU.

    python -m pcrlv2_tpu_torch.tools.probe_mosaic

Port of ``tools/probe_mosaic.py``.  On the TPU each probe compiles and runs
a tiny Pallas kernel (``run``) and reports whether Mosaic could lower it;
it never looks at the values.  On Hopper every probe can be written, so
here each probe's CUDA kernel (``csrc/probe_mosaic.cu``) is held to the
probe's PyTorch expression (``torch.cat``, slicing, ``torch.roll``,
``reshape``, ``.T``, ``einsum``) with tolerance 0: the inputs are
``arange`` integers and the dot's weights ones, so even the dot's f32
sums (all below 2^24) are exact in any order.

Each probe is one launch of one block (``csrc/probe_mosaic.cu``; its
header says what bounds them).  ``plan`` works out a probe's launch (its
dimensions n0, n1, n2 and its output) once per input shapes, so that a call
of ``run`` on the card costs its checks, one output allocation, one stream
read and one C call; ``floor`` takes the same path to an empty kernel, the
least a call can cost.

``main()`` prints ``OK`` or ``FAIL`` per probe, as the JAX tool does, and
returns the number of failures; running the module exits with it.  It needs
a GPU unless ``device="cpu"`` is passed.  ``chip_smoke.py`` phase 9 drives
it.

``run`` given CPU tensors returns the probe's plain version; given CUDA
tensors it launches the probe's kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import sys
from typing import NamedTuple

import torch

from pcrlv2_tpu_torch.ops import _build
from pcrlv2_tpu_torch.tools._common import Case, setup

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = (_I, _P, _P, _P, _I, _I, _I, _P)
_SCRATCH_LIMIT = 48 * 1024  # bytes of the lane-offset store's shared scratch


def _lane_offset_store(a: torch.Tensor) -> torch.Tensor:
    s = a.new_empty((a.shape[0], 2 * a.shape[1]))
    s[:, :a.shape[1]] = a
    s[:, a.shape[1]:] = a
    return s


#: probe name (the JAX tool's) → its plain version, in the JAX tool's order;
#: a probe's index in this dict is its number in ``csrc/probe_mosaic.cu``
PLAIN = {
    "concat lanes 32+32": lambda a, b: torch.cat([a, b], -1),
    "concat lanes 64+64": lambda a, b: torch.cat([a, b], -1),
    "lane slice [32:64] of 128": lambda a: a[:, 32:64],
    "lane slice [64:128] of 128": lambda a: a[:, 64:128],
    "lane-offset store [32:64]": _lane_offset_store,
    "reshape (64,9,32)->(64,288)": lambda a: a.reshape(64, 288),
    "reshape (8,64,32)->(512,32)": lambda a: a.reshape(512, 32),
    "concat sublanes": lambda a, b: torch.cat([a, b], 0),
    "roll lanes by 32": lambda a: torch.roll(a, 32, -1),
    "pltpu.roll lanes by 32": lambda a: torch.roll(a, 32, 1),
    "dot 2 contraction dims": lambda a, w: torch.einsum("mtc,tcn->mn", a, w),
    "transpose 2d": lambda a: a.T,
    "strided lane slice": lambda a: a[:, 0:128:4],
    "bf16 concat lanes 32+32": lambda a, b: torch.cat([a, b], -1),
}
_INDEX = {name: i for i, name in enumerate(PLAIN)}


def plain(name: str, *xs: torch.Tensor) -> torch.Tensor:
    """The probe's PyTorch expression, as a new contiguous tensor."""
    return PLAIN[name](*xs).contiguous()


class Plan(NamedTuple):
    """One probe's launch on inputs of given shapes: ``out`` = (shape,
    dtype) of its output, ``index`` its number in ``csrc/probe_mosaic.cu``,
    the first input viewed as (``n0``, ``n1``), ``n2`` the second input's
    last dimension (the dot's output width; 0 without one), ``scratch`` the
    bytes of shared scratch its kernel needs."""

    out: tuple
    index: int
    n0: int
    n1: int
    n2: int
    scratch: int


@functools.lru_cache(maxsize=None)
def plan(name: str, inputs: tuple) -> Plan:
    """Probe ``name``'s launch on inputs of ``inputs`` = ((shape, dtype),
    ...), worked out once per shapes; the output's (shape, dtype) comes from
    its plain version on meta tensors."""
    want = PLAIN[name](*(torch.empty(s, dtype=dt, device="meta") for s, dt in inputs))
    shape, dtype = inputs[0]
    n0 = shape[0]
    n1 = math.prod(shape) // n0
    n2 = inputs[1][0][-1] if len(inputs) > 1 else 0
    scratch = (2 * n0 * n1 * torch.empty((), dtype=dtype).element_size()
               if name == "lane-offset store [32:64]" else 0)
    return Plan((tuple(want.shape), want.dtype), _INDEX[name], n0, n1, n2, scratch)


def _launch(name: str, p: Plan, xs, index: int) -> torch.Tensor:
    """One C call of probe number ``index`` on ``xs`` by plan ``p``."""
    a = xs[0]
    if p.scratch > _SCRATCH_LIMIT:
        raise ValueError(f"probe {name!r}: its scratch must fit in 48 KB of shared memory")
    out = torch.empty(p.out[0], dtype=p.out[1], device=a.device)
    err = _build.entry("probe_mosaic", "probe_run", a.dtype, _SIG)(
        index, a.data_ptr(), xs[1].data_ptr() if len(xs) > 1 else None, out.data_ptr(),
        p.n0, p.n1, p.n2, _build.stream_ptr(a))
    if err:
        _build.check(err, f"probe {name!r} launch")
    return out


def _checked_plan(name: str, out_shape, xs) -> Plan:
    p = plan(name, tuple((x.shape, x.dtype) for x in xs))
    if (tuple(out_shape[0]), out_shape[1]) != p.out:
        raise ValueError(f"probe {name!r} gives {p.out}, not {tuple(out_shape[0])} "
                         f"{out_shape[1]}")
    return p


def run(name: str, out_shape, *xs: torch.Tensor) -> torch.Tensor:
    """Probe ``name`` on ``xs`` into a new tensor of ``out_shape`` = (shape,
    dtype), as the JAX tool's ``run`` takes it.  Raises if ``out_shape`` is
    not the probe's."""
    p = _checked_plan(name, out_shape, xs)
    if _build.check_inputs(*xs) == "cpu":
        return plain(name, *xs)
    out = _launch(name, p, xs, p.index)
    _build.launches["probe_mosaic"] += 1
    return out


def floor(name: str, out_shape, *xs: torch.Tensor) -> torch.Tensor:
    """``run``'s path on the card with an empty kernel in place of the
    probe's (its output left unwritten): the least a call of that path
    costs, for timing.  No launch counter counts it."""
    p = _checked_plan(name, out_shape, xs)
    if _build.check_inputs(*xs) != "cuda":
        raise RuntimeError("floor launches on the card only")
    return _launch(name, p, xs, -1)


def probes(device) -> list:
    """(name, out_shape, inputs) of the JAX tool's 14 probes, in its order,
    on its inputs: ``arange`` values and, for the dot, ones."""
    f32 = {"dtype": torch.float32, "device": device}
    x = torch.arange(64 * 32, **f32).reshape(64, 32)
    big = torch.arange(64 * 128, **f32).reshape(64, 128)
    x3 = torch.arange(8 * 64 * 32, **f32).reshape(8, 64, 32)
    x64 = torch.arange(64 * 64, **f32).reshape(64, 64)
    x9 = torch.arange(64 * 9 * 32, **f32).reshape(64, 9, 32)
    w9 = torch.ones((9, 32, 16), **f32)
    xb = x.to(torch.bfloat16)
    inputs = [(x, x), (x64, x64), (big,), (big,), (x,), (x9,), (x3,), (x, x), (big,),
              (big,), (x9, w9), (x,), (big,), (xb, xb)]
    return [(name, plan(name, tuple((t.shape, t.dtype) for t in xs)).out, xs)
            for name, xs in zip(PLAIN, inputs)]


def cases(device) -> list:
    """One ``Case`` per probe; the plain version is itself the one PyTorch
    call that computes the probe, so it also stands as the library call."""
    result = []
    for name, out_shape, xs in probes(device):
        nbytes = sum(t.numel() * t.element_size() for t in xs) + (
            math.prod(out_shape[0]) * xs[0].element_size())
        flops = 2.0 * 64 * 288 * 16 if name == "dot 2 contraction dims" else 0.0
        result.append(Case("probe_mosaic", name,
                           lambda name=name, out_shape=out_shape, xs=xs: run(name, out_shape, *xs),
                           lambda name=name, xs=xs: plain(name, *xs),
                           lambda name=name, xs=xs: plain(name, *xs), flops, nbytes))
    return result


def main(device=None) -> int:
    """Run the 14 probes; print OK / FAIL per probe; return the failures."""
    dev = setup(device)
    failures = 0
    for name, out_shape, xs in probes(dev):
        got, want = run(name, out_shape, *xs), plain(name, *xs)
        ok = got.dtype == want.dtype and torch.equal(got, want)
        print(f"{'OK' if ok else 'FAIL':6}{name}", flush=True)
        failures += not ok
    return failures


if __name__ == "__main__":
    sys.exit(main())
