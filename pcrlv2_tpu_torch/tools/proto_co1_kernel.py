"""Kernels #8 and #9: the Co=1 3³ conv prototypes (stencil and banded) on
the GPU.

    python -m pcrlv2_tpu_torch.tools.proto_co1_kernel

Port of ``tools/proto_co1_kernel.py``: the deep-supervision mask head's
SAME 3³ conv with one output channel and no bias, x (B, D, H, W, Ci), w
(3, 3, 3, Ci, 1) → (B, D, H, W), in the JAX tool's two formulations:

* ``conv3d_co1_fwd`` (#8, ``_co1_kernel``): 27 multiply-adds on (H, W, Ci)
  slabs, then a sum over Ci, by the ``co1_stencil`` kernel.  It is the
  function of the mask heads' forward (#3), so it runs #3's block template
  on its own w27 (27, Ci) with #3's geometry (``ops/head_conv.py``:
  ``tile``, ``fwd_split``); Ci above ``head_conv.MAX_CI`` is split into
  channel slices (``stencil_geometry``) whose f32 partials a second launch
  adds in order, and Ci the 16-byte copies cannot take runs zero-padded
  (``head_conv.vector_channels``);
* ``conv3d_co1_band`` (#9, ``_co1_band_kernel``): 9 banded products
  ``plane_td[th:th+H].reshape(H, (W+2)·Ci) @ band[3·td + th]`` by the
  ``co1_band`` kernel, on the bands ``band_mats`` builds outside it.  The
  product does (W+2)/3 times the conv's useful FLOPs, zeros included.  On
  the card it is a GEMM of M = B·D·H rows, N = W, K = 9·(W+2)·Ci: blocks
  of 256 rows (``band_tiles``) × a 16- or 32-column tile (``band_width``),
  K in stages of one depth tap and one chunk of the (W+2)·Ci row
  (``band_stages``), split where the grid is short of the card
  (``conv3d_packed.split``); Ci or W the 16-byte copies cannot take run on
  zero-padded channels and band columns (``band_route``,
  ``band_operands``).

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
import math

import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops import _build
from pcrlv2_tpu_torch.ops import conv3d_kernel as ck
from pcrlv2_tpu_torch.ops import conv3d_packed as cp
from pcrlv2_tpu_torch.ops import head_conv as hc
from pcrlv2_tpu_torch.ops.conv3d_kernel import OFFSETS
from pcrlv2_tpu_torch.tools._common import Case, fmt_ms, rel_err, setup, tflops, time_ms

#: (D, H, W, Ci) of the JAX tool (``tools/proto_co1_kernel.py:104``)
SHAPES = [(64, 64, 32, 64), (32, 32, 16, 128)]
BATCH = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"co1_stencil": (_P,) * 4 + (_I,) * 7 + (_P,),
         "co1_band": (_P,) * 4 + (_I,) * 15 + (_P,)}
#: output rows (b, d, h) of one band block: 256, or 128 where a slab of 256
#: rows of tiny planes would not fit a block's shared memory (H = 1)
_BAND_BM = (256, 128)
#: per dtype: (columns of the (W+2)·Ci row a band stage stages, row pad)
_BAND = {torch.bfloat16: (64, 8), torch.float32: (32, 4)}


def _fn(kind: str, dtype: torch.dtype):
    return _build.entry("proto_co1", kind, dtype, _SIGS[kind])


def stencil_geometry(b: int, d: int, h: int, w: int, ci: int, sms: int,
                     dtype: torch.dtype) -> dict:
    """#8's launch on #3's template, Ci already a multiple of the 16-byte
    copy's width: ``cs`` channels a slice (all Ci up to ``hc.MAX_CI``, else
    ``n_ci`` slices of equal multiples of ``hc.CHUNK``, the last shorter)
    and ``chunk``, the output planes a block walks (``hc.fwd_split``, with
    the slices counted among the blocks)."""
    n_ci = -(-ci // hc.MAX_CI)
    step = hc.CHUNK[dtype]
    cs = ci if n_ci == 1 else -(-ci // (n_ci * step)) * step
    n_ci = -(-ci // cs)
    return {"cs": cs, "n_ci": n_ci, "chunk": hc.fwd_split(b * n_ci, d, h, w, sms, dtype)}


def band_tiles(b: int, d: int, h: int, bn: int, dtype: torch.dtype) -> dict:
    """How #9 cuts its B·D·H output rows into blocks of ``bm`` (the first of
    ``_BAND_BM`` whose block fits the card's shared memory at tile width
    ``bn``), as ``conv3d_packed.tiles`` cuts planes of H × 1 voxels: ``P``
    whole planes of ``L = H`` rows a block, or segments of ``L = bm`` rows
    of one plane; ``rows`` is one stage's slab, ``P·(L + 2)`` rows (each
    segment with a halo row above and below)."""
    for bm in _BAND_BM:
        geo = cp.tiles(b, d, h, 1, bm)
        geo.update(bm=bm, rows=geo["P"] * (geo["L"] + 2))
        if band_smem(geo, bn, dtype) <= cp.SMEM_LIMIT:
            break
    return geo


def band_width(n: int) -> int:
    """Columns of a #9 block's tile: 16 for N ≤ 16, else 32 (a wider N
    takes ``ceil(N / 32)`` column tiles)."""
    return 16 if n <= 16 else 32


def band_stages(w: int, ci: int, dtype: torch.dtype) -> list:
    """#9's K walk as (td, first column) per stage, the column chunks outer
    and td inner (so the three depth planes of a chunk are read close in
    time, and neighbouring blocks find them in L2): a stage covers bands
    3·td .. 3·td + 2 at columns k0 .. k0 + BK − 1 of the (W+2)·Ci row."""
    bk = _BAND[dtype][0]
    return [(td, k0) for k0 in range(0, (w + 2) * ci, bk) for td in range(3)]


def band_route(ci: int, w: int, dtype: torch.dtype) -> str:
    """``"vector"``: Ci and W are multiples of the 16-byte copy's width (8
    bf16, 4 f32), so the w-pad edges fall on vector edges and the band rows
    are aligned; ``"padded"``: any other shape runs the same kernel on
    channels and band columns zero-padded to those multiples."""
    return "vector" if ck.vector_channels(ci, w, dtype, stem=False) == (ci, w) else "padded"


def band_operands(x: torch.Tensor, bands: torch.Tensor, ci: int, n: int):
    """x (…, W, Ci₀) and bands (9, (W+2)·Ci₀, W) zero-padded to ``ci``
    channels (x's and the band rows') and ``n`` band columns."""
    w, ci0 = x.shape[-2:]
    if (ci, n) == (ci0, w):
        return x, bands
    bands = F.pad(bands.reshape(9, w + 2, ci0, w), (0, n - w, 0, ci - ci0))
    return ck.pad_last(x, ci), bands.reshape(9, (w + 2) * ci, n)


def band_smem(geo: dict, bn: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one #9 block: two stages of the slab (BK
    columns, padded) and the 3 band tiles (BK × ``bn``, padded), plus the
    slab's row table."""
    bk, pad = _BAND[dtype]
    es = torch.tensor([], dtype=dtype).element_size()
    return es * 2 * (geo["rows"] * (bk + pad) + 3 * bk * (bn + pad)) + 8 * geo["rows"]


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
    if x.numel() == 0:
        raise ValueError(f"co1_stencil takes a non-empty input, got {tuple(x.shape)}")
    civ = hc.vector_channels(ci, x.dtype)
    if civ != ci:
        x, w27 = ck.pad_last(x, civ), F.pad(w27, (0, civ - ci))
    if x.data_ptr() % 16:
        raise ValueError("co1_stencil needs a 16-byte aligned x")
    geo = stencil_geometry(b, d, h, w, civ, _build.sm_count(x.device), x.dtype)
    out = torch.empty((b, d, h, w), dtype=x.dtype, device=x.device)
    partial = (torch.empty((geo["n_ci"], b * d * h * w), dtype=torch.float32, device=x.device)
               if geo["n_ci"] > 1 else None)
    err = _fn("co1_stencil", x.dtype)(
        x.data_ptr(), w27.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), b, d, h, w, civ, geo["cs"],
        geo["chunk"], _build.stream_ptr(x))
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
    ci_p, n = ck.vector_channels(ci, w, x.dtype, stem=False)
    xk, bk = band_operands(x, bands, ci_p, n)
    ck.check_vectors((xk, bk), ci_p, n)
    bn = band_width(n)
    geo = band_tiles(b, d, h, bn, x.dtype)
    smem = band_smem(geo, bn, x.dtype)
    if smem > cp.SMEM_LIMIT:
        raise ValueError(f"co1_band: H={h} needs {smem} bytes of shared memory per "
                         f"block, more than the {cp.SMEM_LIMIT} a block has")
    s, per = cp.split(geo["tiles"] * math.ceil(n / bn), len(band_stages(w, ci_p, x.dtype)),
                      _build.sm_count(x.device))
    out = torch.empty((b, d, h, n), dtype=x.dtype, device=x.device)
    partial = (torch.empty((s, b * d * h, n), dtype=torch.float32, device=x.device)
               if s > 1 else None)
    err = _fn("co1_band", x.dtype)(
        xk.data_ptr(), bk.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), b, d, h, w, ci_p, n, geo["P"],
        geo["L"], geo["tpp"], geo["rows"], geo["tiles"], geo["bm"], bn, s, per,
        _build.stream_ptr(x))
    _build.check(err, "co1_band launch")
    _build.launches["proto_co1_band"] += 1
    return out if n == w else out[..., :w].contiguous()


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
    useful work; the banded case's ``product_flops`` its own."""
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
                 lambda: band_plain(x, bands), cudnn, flops, nbytes,
                 band_flops(batch, shape))]


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
            fl = case.product_flops
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
