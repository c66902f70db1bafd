"""Kernel #7: the im2col conv prototype, CONCAT27 and CONCAT9, on the GPU.

    python -m pcrlv2_tpu_torch.tools.proto_conv

Port of ``tools/proto_conv.py``: a SAME 3³ conv with bias, x (B, D, H, W, Ci)
NDHWC, w (3, 3, 3, Ci, Co) DHWIO, bias (Co,), accumulated in f32 from the
bias and cast to x's dtype, in two formulations of the TPU kernel
(``_make_kernel``): ``mode="27"``, one contraction of K = 27·Ci over the 27
tap windows side by side, and ``mode="9"``, three contractions of K = 9·Ci,
one per depth tap.  The CUDA source is ``csrc/proto_conv.cu``, one kernel
template on the taps staged per pass; its header says what bounds it and how
the tiling answers it.

``main()`` sweeps the JAX tool's shapes at B = 32 in bf16 and prints, per
shape, the cuDNN conv's time (a yardstick only, where the JAX tool prints
XLA's), each variant's time and TFLOP/s, and its error against the plain
version.  It needs a GPU unless ``device="cpu"`` is passed (then it runs the
plain versions and times nothing).  ``chip_smoke.py`` phase 9 drives it.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops import _build
from pcrlv2_tpu_torch.ops.conv3d_kernel import OFFSETS
from pcrlv2_tpu_torch.tools._common import Case, fmt_ms, rel_err, setup, tflops, time_ms

#: (D, H, W, Ci, Co) of the JAX tool's sweep (``tools/proto_conv.py:115-120``)
SHAPES = [(64, 64, 32, 32, 64), (32, 32, 16, 64, 64), (32, 32, 16, 64, 128),
          (64, 64, 32, 64, 64), (64, 64, 32, 128, 64), (64, 64, 32, 64, 1)]
BATCH = 32
MODES = ("27", "9")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = (_P, _P, _P, _P) + (_I,) * 11 + (_L, _P)


_BM = 64   # output rows (voxels) per block (csrc/conv_tile.cuh)
_BN = 64   # output channels per block
#: shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448


def tiles(b: int, d: int, h: int, w: int) -> dict:
    """How the kernel cuts the output into blocks of 64 voxels: planes of at
    least 64 voxels in ``tpp`` segments of ``L = 64`` consecutive positions
    (``P = 1``); smaller planes ``P = 64 // (h·w)`` whole to a block
    (``L = h·w``).  ``rows`` is the most input rows of one plane a block
    stages, halo included."""
    hw = h * w
    if hw >= _BM:
        p, seg, tpp = 1, _BM, math.ceil(hw / _BM)
        n = b * d * tpp
        rows = (w + _BM - 2) // w + 3
    else:
        p, seg, tpp = _BM // hw, hw, 1
        n = math.ceil(b * d / p)
        rows = h + 2
    return {"P": p, "L": seg, "tpp": tpp, "tiles": n, "rows": rows}


def taps_per_pass(mode: str) -> int:
    return 27 if mode == "27" else 9


def chunk_channels(mode: str) -> int:
    """Input channels the kernel stages per pass (``csrc/proto_conv.cu``)."""
    return 8 if mode == "27" else 16


def smem_bytes(mode: str, geo: dict, w: int) -> int:
    """Dynamic shared memory of one block: the staged depth planes (leading
    dimension padded by one float, rounded up to 16 bytes) and the weights."""
    taps, ck = taps_per_pass(mode), chunk_channels(mode)
    slab = taps // 9 * geo["P"] * geo["rows"] * (w + 2) * (ck + 1)
    return 4 * (-(-slab // 4) * 4) + 4 * taps * ck * _BN


# ---------------------------------------------------------------------------
# plain version (CPU path and the card-side reference)
# ---------------------------------------------------------------------------


def conv_plain(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor, mode: str,
               chunk: int | None = 1) -> torch.Tensor:
    """``bias + Σ_pass cols_pass @ wmat[rows of the pass]`` in f32, the
    pass's tap windows side by side (27 taps in one pass, or 9 per depth
    tap), cast to ``x.dtype``.  ``chunk`` samples at a time (``None``: the
    whole batch at once): at (64, 64, 32) Ci = 128 one sample's 27 windows
    are 1.8 GB of f32."""
    b, d, h, w, ci = x.shape
    co = wmat.shape[-1]
    taps = taps_per_pass(mode)
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    step = b if chunk is None else chunk
    for b0 in range(0, b, step):
        xp = F.pad(x[b0:b0 + step], (0, 0, 1, 1, 1, 1, 1, 1)).float()
        n = xp.shape[0] * d * h * w
        acc = bias.float().expand(n, co)
        for t0 in range(0, 27, taps):
            cols = torch.cat([xp[:, td:td + d, th:th + h, tw:tw + w].reshape(n, ci)
                              for td, th, tw in OFFSETS[t0:t0 + taps]], -1)
            acc = acc + cols @ wmat[t0 * ci:(t0 + taps) * ci].float()
        out[b0:b0 + step] = acc.reshape(-1, d, h, w, co).to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# kernel wrapper and the tool's function
# ---------------------------------------------------------------------------


def proto_conv(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
               mode: str) -> torch.Tensor:
    """Kernel #7: x (B, D, H, W, Ci), wmat (27·Ci, Co), bias (Co,), all of
    one dtype → (B, D, H, W, Co) in that dtype; ``mode`` "27" or "9"."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, d, h, w, ci = x.shape
    if wmat.dim() != 2 or wmat.shape[0] != 27 * ci or bias.shape != wmat.shape[1:]:
        raise ValueError(f"weights {tuple(wmat.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit Ci={ci}")
    if _build.check_inputs(x, wmat, bias) == "cpu":
        return conv_plain(x, wmat, bias, mode)
    if x.numel() == 0:
        raise ValueError(f"proto_conv takes a non-empty input, got {tuple(x.shape)}")
    kind = f"proto_conv{mode}"
    co = wmat.shape[1]
    geo = tiles(b, d, h, w)
    smem = smem_bytes(mode, geo, w)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kind}: W={w} needs {smem} bytes of shared memory per "
                         f"block, more than the {SMEM_LIMIT} a block has")
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    err = _build.entry("proto_conv", kind, x.dtype, _SIG)(
        x.data_ptr(), wmat.data_ptr(), bias.data_ptr(), out.data_ptr(), b, d, h, w,
        ci, co, geo["P"], geo["L"], geo["tpp"], geo["tiles"], geo["rows"], smem,
        _build.stream_ptr(x))
    _build.check(err, f"{kind} launch")
    _build.launches[kind] += 1
    return out


def conv3d_im2col(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  mode: str = "27") -> torch.Tensor:
    """SAME 3³ conv, x (B, D, H, W, Ci), w (3, 3, 3, Ci, Co), bias (Co,), as
    the JAX tool's ``conv3d_im2col``: weights and bias cast to x's dtype."""
    ci, co = w.shape[3:]
    return proto_conv(x, w.to(x.dtype).reshape(27 * ci, co).contiguous(),
                      bias.to(x.dtype).contiguous(), mode)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def shape_cases(shape, batch: int, dtype: torch.dtype, device, seed: int = 0):
    """Inputs from ``seed`` at one sweep shape (x normal, w 0.1·normal, bias
    normal, as the JAX tool draws them) and its two cases, one per mode."""
    d, h, w, ci, co = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, d, h, w, ci), generator=gen, device=device).to(dtype)
    wt = (torch.randn((3, 3, 3, ci, co), generator=gen, device=device) * 0.1).to(dtype)
    bias = torch.randn((co,), generator=gen, device=device).to(dtype)
    wmat = wt.reshape(27 * ci, co).contiguous()
    x_nc, w_nc = x.permute(0, 4, 1, 2, 3), wt.permute(4, 3, 0, 1, 2)
    m = batch * d * h * w
    es = x.element_size()
    label = f"({d},{h},{w}) {ci:3d}->{co:3d}"
    return [Case(f"proto_conv{mode}", label,
                 lambda mode=mode: conv3d_im2col(x, wt, bias, mode),
                 lambda mode=mode: conv_plain(x, wmat, bias, mode),
                 lambda: F.conv3d(x_nc, w_nc, bias, padding=1),
                 2.0 * m * 27 * ci * co, es * (m * (ci + co) + 27 * ci * co + co))
            for mode in MODES]


def cases(device, batch: int = BATCH, dtype: torch.dtype = torch.bfloat16, shapes=SHAPES):
    for shape in shapes:
        yield from shape_cases(shape, batch, dtype, device)


def main(device=None, batch: int = BATCH, dtype: torch.dtype = torch.bfloat16,
         shapes=SHAPES) -> list:
    """Run the sweep; returns one dict per (shape, mode) with the error
    against the plain version and the times (None on the CPU)."""
    dev = setup(device)
    rows = []
    for shape in shapes:
        pair = shape_cases(shape, batch, dtype, dev)
        t_lib = time_ms(pair[0].library, dev)
        line = f"{pair[0].label}: cudnn {fmt_ms(t_lib)}{tflops(pair[0].flops, t_lib)}"
        for case in pair:
            err = rel_err(case.run(), case.plain())
            t = time_ms(case.run, dev)
            speed = "" if t is None else f" ({t_lib / t:4.2f}x cudnn)"
            line += (f" | {case.kernel} {fmt_ms(t)}{tflops(case.flops, t)}{speed}, "
                     f"err {err:.1e}")
            rows.append({"kernel": case.kernel, "case": case.label, "rel_err": err,
                         "ms": t, "library_ms": t_lib})
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
