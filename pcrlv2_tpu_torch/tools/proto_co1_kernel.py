"""Kernels #8 and #9: the Co=1 3³ conv prototypes (stencil and banded) on
the GPU.

    python -m pcrlv2_tpu_torch.tools.proto_co1_kernel

Port of ``tools/proto_co1_kernel.py``: the deep-supervision mask head's
SAME 3³ conv with one output channel and no bias, x (B, D, H, W, Ci), w
(3, 3, 3, Ci, 1) → (B, D, H, W), in the JAX tool's two formulations:

* ``conv3d_co1_fwd`` (#8, ``_co1_kernel``): 27 multiply-adds on (H, W, Ci)
  slabs, then a sum over Ci, by the ``co1_stencil`` kernel;
* ``conv3d_co1_band`` (#9, ``_co1_band_kernel``): 9 banded products
  ``plane_td[th:th+H].reshape(H, (W+2)·Ci) @ band[3·td + th]`` by the
  ``co1_band`` kernel, on the bands ``band_mats`` builds outside it.  The
  product does (W+2)/3 times the conv's useful FLOPs, zeros included.

The CUDA source is ``csrc/proto_co1.cu``; its header says what bounds each
kernel and how the design answers it.  The TPU stencil forms each product
in the input dtype and widens it; the CUDA kernel widens the inputs and
multiplies in f32 (within one bf16 rounding of the output).

``main()`` runs the stencil at the JAX tool's two shapes at B = 32 in bf16,
``main2()`` the banded form; each prints the cuDNN conv's time (a yardstick
only), the kernel's time and its error against the plain version.  As in
the JAX file, running the module runs ``main()`` only.  Both need a GPU
unless ``device="cpu"`` is passed.  ``chip_smoke.py`` phase 9 calls both.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops import _build
from pcrlv2_tpu_torch.ops.conv3d_kernel import OFFSETS
from pcrlv2_tpu_torch.tools._common import Case, fmt_ms, rel_err, setup, tflops, time_ms

#: (D, H, W, Ci) of the JAX tool (``tools/proto_co1_kernel.py:104``)
SHAPES = [(64, 64, 32, 64), (32, 32, 16, 128)]
BATCH = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {"co1_stencil": (_P, _P, _P) + (_I,) * 6 + (_L, _P),
         "co1_band": (_P, _P, _P) + (_I,) * 5 + (_P,)}
_STENCIL_VOXELS = 256   # voxels one stencil block covers at most
_STENCIL_CHUNK = 16     # channels it stages per pass


def _fn(kind: str, dtype: torch.dtype):
    return _build.entry("proto_co1", kind, dtype, _SIGS[kind])


def stencil_rows(h: int, w: int) -> int:
    """Output rows of one plane a stencil block covers (TH·W ≤ 256)."""
    return max(1, min(h, _STENCIL_VOXELS // w))


def band_mats(w: torch.Tensor, wd: int) -> torch.Tensor:
    """(9, (wd+2)·Ci, wd) banded weights of w (3, 3, 3, Ci, 1), in w's
    dtype: ``band[3·td + th][(wi, c), wo] = w[td, th, wi − wo, c]`` for
    wi − wo in {0, 1, 2}, else 0 (``_band_mats``)."""
    ci = w.shape[3]
    bands = w.new_zeros((3, 3, wd + 2, ci, wd))
    wo = torch.arange(wd, device=w.device)
    for tw in range(3):
        # advanced indices on dims 2 and 4: the value broadcasts over wo
        bands[:, :, wo + tw, :, wo] = w[:, :, tw, :, 0]
    return bands.reshape(9, (wd + 2) * ci, wd)


# ---------------------------------------------------------------------------
# plain versions (CPU path and the card-side reference)
# ---------------------------------------------------------------------------


def co1_plain(x: torch.Tensor, w27: torch.Tensor, chunk: int | None = 1) -> torch.Tensor:
    """``Σ_c Σ_t window_t(x)[..., c] · w27[t, c]`` in f32 (the 27 products
    added into an (H, W, Ci) sum, then the sum over Ci), cast to x's dtype;
    ``chunk`` samples at a time (``None``: all at once)."""
    b, d, h, w, ci = x.shape
    out = torch.empty((b, d, h, w), dtype=x.dtype, device=x.device)
    step = b if chunk is None else chunk
    for b0 in range(0, b, step):
        xp = F.pad(x[b0:b0 + step], (0, 0, 1, 1, 1, 1, 1, 1)).float()
        acc = torch.zeros(xp.shape[:1] + (d, h, w, ci), device=x.device)
        for t, (td, th, tw) in enumerate(OFFSETS):
            acc += xp[:, td:td + d, th:th + h, tw:tw + w] * w27[t].float()
        out[b0:b0 + step] = acc.sum(-1).to(x.dtype)
    return out


def band_plain(x: torch.Tensor, bands: torch.Tensor, chunk: int | None = 1) -> torch.Tensor:
    """``Σ_{td,th} xpad[:, td:td+D, th:th+H].reshape(.., (W+2)·Ci) @
    bands[3·td + th]`` in f32, cast to x's dtype; ``chunk`` samples at a
    time (``None``: all at once)."""
    b, d, h, w, ci = x.shape
    out = torch.empty((b, d, h, w), dtype=x.dtype, device=x.device)
    step = b if chunk is None else chunk
    bf = bands.float()
    for b0 in range(0, b, step):
        xp = F.pad(x[b0:b0 + step], (0, 0, 1, 1, 1, 1, 1, 1)).float()
        xp = xp.reshape(xp.shape[0], d + 2, h + 2, (w + 2) * ci)
        acc = torch.zeros(xp.shape[:1] + (d, h, w), device=x.device)
        for td in range(3):
            for th in range(3):
                acc += xp[:, td:td + d, th:th + h] @ bf[3 * td + th]
        out[b0:b0 + step] = acc.to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers and the tool's functions
# ---------------------------------------------------------------------------


def co1_stencil(x: torch.Tensor, w27: torch.Tensor) -> torch.Tensor:
    """Kernel #8: x (B, D, H, W, Ci), w27 (27, Ci), one dtype → (B, D, H, W)."""
    b, d, h, w, ci = x.shape
    if tuple(w27.shape) != (27, ci):
        raise ValueError(f"weights {tuple(w27.shape)} do not fit Ci={ci}")
    if _build.check_inputs(x, w27) == "cpu":
        return co1_plain(x, w27)
    if x.numel() == 0 or w > _STENCIL_VOXELS:
        raise ValueError(f"co1_stencil takes a non-empty input with W <= "
                         f"{_STENCIL_VOXELS}, got {tuple(x.shape)}")
    th = stencil_rows(h, w)
    smem = 4 * 3 * (th + 2) * (w + 2) * _STENCIL_CHUNK
    out = torch.empty((b, d, h, w), dtype=x.dtype, device=x.device)
    err = _fn("co1_stencil", x.dtype)(x.data_ptr(), w27.data_ptr(), out.data_ptr(),
                                      b, d, h, w, ci, th, smem, _build.stream_ptr(x))
    _build.check(err, "co1_stencil launch")
    _build.launches["proto_co1"] += 1
    return out


def co1_band(x: torch.Tensor, bands: torch.Tensor) -> torch.Tensor:
    """Kernel #9: x (B, D, H, W, Ci), bands (9, (W+2)·Ci, W), one dtype →
    (B, D, H, W)."""
    b, d, h, w, ci = x.shape
    if tuple(bands.shape) != (9, (w + 2) * ci, w):
        raise ValueError(f"bands {tuple(bands.shape)} do not fit W={w}, Ci={ci}")
    if _build.check_inputs(x, bands) == "cpu":
        return band_plain(x, bands)
    if x.numel() == 0:
        raise ValueError(f"co1_band takes a non-empty input, got {tuple(x.shape)}")
    out = torch.empty((b, d, h, w), dtype=x.dtype, device=x.device)
    err = _fn("co1_band", x.dtype)(x.data_ptr(), bands.data_ptr(), out.data_ptr(),
                                   b, d, h, w, ci, _build.stream_ptr(x))
    _build.check(err, "co1_band launch")
    _build.launches["proto_co1_band"] += 1
    return out


def conv3d_co1_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, Ci), w (3, 3, 3, Ci, 1) → (B, D, H, W), by #8."""
    return co1_stencil(x, w[..., 0].to(x.dtype).reshape(27, x.shape[-1]).contiguous())


def conv3d_co1_band(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function by #9, on ``band_mats`` of w cast to x's dtype."""
    return co1_band(x, band_mats(w.to(x.dtype), x.shape[3]).contiguous())


# ---------------------------------------------------------------------------
# the two sweeps
# ---------------------------------------------------------------------------


def band_flops(batch: int, shape) -> float:
    """FLOPs of the banded product: (W+2)/3 times the conv's useful ones."""
    d, h, w, ci = shape
    return 2.0 * batch * d * h * w * 9 * (w + 2) * ci


def shape_cases(shape, batch: int, dtype: torch.dtype, device, seed: int = 0):
    """Inputs from ``seed`` at one shape (x normal, w 0.1·normal, as the JAX
    tool draws them) and its two cases: the stencil (#8) and the banded
    product (#9) on bands built once.  Both cases' ``flops`` are the conv's
    useful work."""
    d, h, w, ci = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, d, h, w, ci), generator=gen, device=device).to(dtype)
    wt = (torch.randn((3, 3, 3, ci, 1), generator=gen, device=device) * 0.1).to(dtype)
    w27 = wt[..., 0].reshape(27, ci).contiguous()
    bands = band_mats(wt, w).contiguous()
    x_nc, w_nc = x.permute(0, 4, 1, 2, 3), wt.permute(4, 3, 0, 1, 2)
    m = batch * d * h * w
    flops = 2.0 * m * 27 * ci
    nbytes = x.element_size() * (m * (ci + 1) + 27 * ci)
    label = f"{d}x{h}x{w} ci={ci}"

    def cudnn():
        return F.conv3d(x_nc, w_nc, padding=1)[:, 0]

    return [Case("proto_co1", label, lambda: conv3d_co1_fwd(x, wt),
                 lambda: co1_plain(x, w27), cudnn, flops, nbytes),
            Case("proto_co1_band", label, lambda: co1_band(x, bands),
                 lambda: band_plain(x, bands), cudnn, flops, nbytes)]


def cases(device, batch: int = BATCH, dtype: torch.dtype = torch.bfloat16, shapes=SHAPES):
    for shape in shapes:
        yield from shape_cases(shape, batch, dtype, device)


def _sweep(which: int, name: str, device, batch, dtype, shapes) -> list:
    dev = setup(device)
    rows = []
    for shape in shapes:
        case = shape_cases(shape, batch, dtype, dev)[which]
        err = rel_err(case.run(), case.plain())
        t_lib, t = time_ms(case.library, dev), time_ms(case.run, dev)
        speed = "" if t is None else f" ({t_lib / t:4.2f}x cudnn)"
        extra = ""
        if which == 1:
            fl = band_flops(batch, shape)
            extra = (f"; useful {case.flops:.3e} FLOPs, banded product {fl:.3e} "
                     f"({fl / case.flops:.1f}x){tflops(fl, t)}")
        print(f"{name} {case.label}: cudnn {fmt_ms(t_lib)} | kernel {fmt_ms(t)}"
              f"{speed}, err {err:.1e}{extra}", flush=True)
        rows.append({"kernel": case.kernel, "case": case.label, "rel_err": err,
                     "ms": t, "library_ms": t_lib})
    return rows


def main(device=None, batch: int = BATCH, dtype: torch.dtype = torch.bfloat16,
         shapes=SHAPES) -> list:
    """The stencil (#8) at each shape; returns one dict per shape with the
    error against the plain version and the times (None on the CPU)."""
    return _sweep(0, "co1", device, batch, dtype, shapes)


def main2(device=None, batch: int = BATCH, dtype: torch.dtype = torch.bfloat16,
          shapes=SHAPES) -> list:
    """The banded form (#9) at each shape, as ``main``."""
    return _sweep(1, "co1-band", device, batch, dtype, shapes)


if __name__ == "__main__":
    main()
