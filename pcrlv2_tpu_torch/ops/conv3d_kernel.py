"""SAME 3³ conv3d: CUDA kernels, their plain versions and the autograd glue.

Port of ``pcrlv2_tpu/ops/pallas_conv.py::conv3d_pallas`` (``_fwd_kernel`` and
``_dw_kernel``).  Activations are NDHWC; parameters use the reference torch
layout (Co, Ci, 3, 3, 3) and are repacked to (27, Ci, Co) on every call, with
tap ``t = 9·td + 3·th + tw``.  The CUDA source is ``csrc/conv3d.cu``; its
header says what bounds each kernel on the H100 and how the design answers it.

* forward: ``out = bias + Σ_t window_t(x) @ W[t]``, f32 accumulation; an
  implicit GEMM of ``_BM``-voxel × ``fwd_tile``-channel tiles (N follows
  Co), K split where the grid is short of the card (``fwd_split``) and the
  splits' f32 partials added in a fixed order; bf16 on tensor cores, f32 on
  CUDA cores;
* dx: the same forward kernel on the spatially flipped, io-swapped weights
  (a SAME 3³ conv's adjoint);
* dw: ``dw[t] = Σ_voxels window_t(x)ᵀ · g`` (f32), one (tap, Ci tile, Co
  tile) per block (``dw_tile``) and the voxels split in chunks
  (``dw_split``), then a fixed-order sum of the chunks' partials;
* the stem (Ci = 1) takes a scalar-gather kernel of its own, forward and dw;
* db: ``g.sum`` in f32.

The kernels copy 16-byte vectors: Ci (unless 1) and Co must be multiples
of 8 (bf16) or 4 (f32) and every pointer 16-byte aligned.  A wrapper given
other channel counts zero-pads them to those multiples, launches on the
padded tensors and slices the result back (``route``, ``padded_operands``):
zero channels add exact zeros to every sum.  It raises on an unaligned
pointer (``check_vectors``).

A wrapper given CPU tensors runs the plain version (the same 27 shifted-window
products with f32 accumulation); given CUDA tensors it launches the kernel or
raises.  It never falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops import _build

#: tap t = 9·td + 3·th + tw
OFFSETS = [(td, th, tw) for td in range(3) for th in range(3) for tw in range(3)]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {
    "conv3d_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "conv3d_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _P),
}
_BM = 128                                    # voxel rows of a forward tile
_BK = {torch.bfloat16: 32, torch.float32: 16}  # K chunk (channels or voxels)
_VEC = {torch.bfloat16: 8, torch.float32: 4}   # elements per 16-byte copy
_DW_CHUNK = 32   # the dw voxel chunks are multiples of this (both _BK values)


def _fn(kind: str, dtype: torch.dtype):
    return _build.entry("conv3d", kind, dtype, _SIGS[kind])


# ---------------------------------------------------------------------------
# weight layouts
# ---------------------------------------------------------------------------


def repack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) → (27, Ci, Co), row ``t`` = tap (td, th, tw).  On the
    CPU as two 2-D transposes: its strided copy of the one 5-D permute runs
    at a quarter of their speed (the same values either way)."""
    co, ci = w.shape[:2]
    if w.device.type == "cpu":
        w = w.reshape(co, ci * 27).t().contiguous().reshape(ci, 27, co).transpose(0, 1)
        return w.to(dtype).contiguous()
    return w.permute(2, 3, 4, 1, 0).reshape(27, ci, co).to(dtype).contiguous()


def flipped_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dx weights: spatially flipped, io-swapped → (27, Co, Ci).  The flip of
    all three axes reverses the tap index t; on the CPU that is a 2-D
    transpose and a flip of its rows (as ``repack_weight``, faster there)."""
    co, ci = w.shape[:2]
    if w.device.type == "cpu":
        w = w.reshape(co * ci, 27).t().contiguous().flip(0).reshape(27, co, ci)
        return w.to(dtype).contiguous()
    return w.flip(2, 3, 4).permute(2, 3, 4, 0, 1).reshape(27, co, ci).to(
        dtype).contiguous()


def unpack_weight_grad(dw: torch.Tensor) -> torch.Tensor:
    """(27, Ci, Co) → (Co, Ci, 3, 3, 3)."""
    _, ci, co = dw.shape
    return dw.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2)


# ---------------------------------------------------------------------------
# plain versions (CPU path and the card-side reference)
# ---------------------------------------------------------------------------


def windows(x: torch.Tensor):
    """Yield (t, window_t(x) as (N, C) f32) for the 27 SAME taps."""
    b, d, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    for t, (td, th, tw) in enumerate(OFFSETS):
        yield t, xp[:, td:td + d, th:th + h, tw:tw + w, :].reshape(-1, c).float()


def conv3d_fwd_plain(x: torch.Tensor, wmat: torch.Tensor,
                     bias: torch.Tensor | None) -> torch.Tensor:
    """``bias + Σ_t window_t(x) @ wmat[t]`` in f32, cast to ``x.dtype``."""
    b, d, h, w, _ = x.shape
    co = wmat.shape[-1]
    acc = torch.zeros(b * d * h * w, co, dtype=torch.float32, device=x.device)
    if bias is not None:
        acc += bias.float()
    for t, win in windows(x):
        acc += win @ wmat[t].float()
    return acc.reshape(b, d, h, w, co).to(x.dtype)


def conv3d_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dw[t] = window_t(x)ᵀ @ g`` in f32 → (27, Ci, Co)."""
    ci, co = x.shape[-1], g.shape[-1]
    g2 = g.reshape(-1, co).float()
    out = torch.empty(27, ci, co, dtype=torch.float32, device=x.device)
    for t, win in windows(x):
        out[t] = win.T @ g2
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def fwd_tile(ci: int, co: int) -> int:
    """Columns of the forward tile: N follows Co (32, 64 or 128), so level
    0's Co = 32..64 is not padded to 128; 0 for the stem (Ci = 1), whose
    kernel takes every column."""
    if ci == 1:
        return 0
    return 128 if co >= 128 else 64 if co >= 64 else 32


def fwd_split(m: int, k: int, co: int, sms: int, bk: int) -> tuple[int, int]:
    """(splits, K per split) of the forward's reduction (K = 27·Ci, chunks of
    ``bk``): where the ``_BM`` × ``fwd_tile`` grid has fewer than two blocks
    per SM, split K so it has about two, each split at least 8 chunks deep.
    The stem (K = 27) is never split."""
    if k == 27:
        return 1, k
    tiles = math.ceil(m / _BM) * math.ceil(co / fwd_tile(k // 27, co))
    chunks = math.ceil(k / bk)
    s = 1 if tiles >= 2 * sms else max(1, min(math.ceil(2 * sms / tiles), chunks // 8))
    kchunk = math.ceil(chunks / s) * bk
    return math.ceil(k / kchunk), kchunk


def dw_tile(ci: int, co: int) -> tuple[int, int]:
    """(channel, column) tile of one filter-grad block: (32, 64) for Ci < 64
    (the model's Ci = 32 layer has Co = 64), else (64, 64 or 128 as Co
    allows); (1, 32) for the stem."""
    if ci == 1:
        return 1, 32
    if ci < 64:
        return 32, 64
    return 64, (128 if co >= 128 else 64)


def dw_split(m: int, rows: int, co: int, sms: int) -> tuple[int, int]:
    """(chunks, voxels per chunk) for the filter-grad reduction over ``m``
    voxels, ``rows`` = 27·Ci: enough chunks that the partial launch has about
    four blocks per SM, each a multiple of ``_DW_CHUNK`` voxels."""
    bm, bn = dw_tile(rows // 27, co)
    tiles = (27 if bm > 1 else 1) * math.ceil(rows // 27 / bm) * math.ceil(co / bn)
    s = max(1, min(math.ceil(m / _DW_CHUNK), math.ceil(4 * sms / tiles)))
    chunk = math.ceil(math.ceil(m / s) / _DW_CHUNK) * _DW_CHUNK
    return math.ceil(m / chunk), chunk


def vector_channels(ci: int, co: int, dtype: torch.dtype, stem: bool = True) -> tuple[int, int]:
    """(Ci, Co) as the kernels run them: each rounded up to a multiple of
    ``_VEC``, except Ci = 1 where ``stem`` (the stem kernels take it)."""
    vec = _VEC[dtype]
    return (1 if stem and ci == 1 else -(-ci // vec) * vec), -(-co // vec) * vec


def route(ci: int, co: int, dtype: torch.dtype) -> str:
    """Which launch a (Ci, Co) conv takes on the card, forward and filter
    grad: ``"stem"`` (Ci = 1, the scalar-gather kernels), ``"vector"`` (Ci
    and Co multiples of ``_VEC``: the tensors as they are) or ``"padded"``
    (the same tensor-core / FMA kernels on zero-padded channels)."""
    if ci == 1:
        return "stem"
    return "vector" if vector_channels(ci, co, dtype) == (ci, co) else "padded"


def pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with its last axis zero-padded to ``n`` (``t`` itself if it fits)."""
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def padded_operands(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor | None,
                    ci: int, co: int):
    """x (…, Ci₀), wmat (27, Ci₀, Co₀), bias (Co₀,) zero-padded to ``ci``
    input and ``co`` output channels (unchanged where they already fit)."""
    ci0, co0 = wmat.shape[1:]
    if (ci0, co0) == (ci, co):
        return x, wmat, bias
    return (pad_last(x, ci), F.pad(wmat, (0, co - co0, 0, ci - ci0)),
            None if bias is None else pad_last(bias, co))


def check_vectors(tensors, ci: int, co: int) -> None:
    """Raise unless the kernels' 16-byte copies can take these tensors: Ci
    (unless 1, the stem) and Co multiples of ``_VEC`` and every pointer
    16-byte aligned."""
    vec = _VEC[tensors[0].dtype]
    if ci != 1 and ci % vec:
        raise ValueError(f"Ci={ci}: the kernels take Ci = 1 or a multiple of {vec}")
    if co % vec:
        raise ValueError(f"Co={co}: the kernels take a multiple of {vec}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernels need 16-byte aligned tensors")


def _sms(x: torch.Tensor) -> int:
    return _build.sm_count(x.device)


def conv3d_fwd(x: torch.Tensor, wmat: torch.Tensor,
               bias: torch.Tensor | None) -> torch.Tensor:
    """SAME 3³ conv: x (B, D, H, W, Ci), wmat (27, Ci, Co), bias (Co,) or None,
    all of one dtype → (B, D, H, W, Co) in that dtype."""
    b, d, h, w, ci = x.shape
    if wmat.shape[:2] != (27, ci):
        raise ValueError(f"weights {tuple(wmat.shape)} do not fit Ci={ci}")
    co = wmat.shape[2]
    tensors = (x, wmat) if bias is None else (x, wmat, bias)
    if _build.check_inputs(*tensors) == "cpu":
        return conv3d_fwd_plain(x, wmat, bias)
    ci0, co0 = ci, co
    ci, co = vector_channels(ci, co, x.dtype)
    x, wmat, bias = padded_operands(x, wmat, bias, ci, co)
    check_vectors((x, wmat), ci, co)
    m = b * d * h * w
    s, kchunk = fwd_split(m, 27 * ci, co, _sms(x), _BK[x.dtype])
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    partial = torch.empty((s, m, co), dtype=torch.float32, device=x.device) if s > 1 else None
    err = _fn("conv3d_fwd", x.dtype)(
        x.data_ptr(), wmat.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        b, d, h, w, ci, co, fwd_tile(ci, co), s, kchunk, _build.stream_ptr(x))
    _build.check(err, "conv3d_fwd launch")
    _build.launches["conv3d_fwd"] += 1
    return out if co == co0 else out[..., :co0].contiguous()


def conv3d_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Filter gradient: x (B, D, H, W, Ci), g (B, D, H, W, Co) → (27, Ci, Co) f32."""
    b, d, h, w, ci = x.shape
    co = g.shape[-1]
    if g.shape[:4] != x.shape[:4]:
        raise ValueError(f"g {tuple(g.shape)} does not match x {tuple(x.shape)}")
    if _build.check_inputs(x, g) == "cpu":
        return conv3d_dw_plain(x, g)
    ci0, co0 = ci, co
    ci, co = vector_channels(ci, co, x.dtype)
    x, g = pad_last(x, ci), pad_last(g, co)
    check_vectors((x, g), ci, co)
    bm, bn = dw_tile(ci, co)
    s, chunk = dw_split(b * d * h * w, 27 * ci, co, _sms(x))
    partial = torch.empty((s, 27 * ci, co), dtype=torch.float32, device=x.device)
    out = torch.empty((27, ci, co), dtype=torch.float32, device=x.device)
    err = _fn("conv3d_dw", x.dtype)(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
        b, d, h, w, ci, co, bm, bn, s, chunk, _build.stream_ptr(x))
    _build.check(err, "conv3d_dw launch")
    _build.launches["conv3d_dw"] += 1
    return out if (ci, co) == (ci0, co0) else out[:, :ci0, :co0].contiguous()


class _Conv3dFn(torch.autograd.Function):
    """Mirrors the custom VJPs of ``conv3d_pallas`` (``pallas_conv.py:253-275``)
    and its packed and im2col siblings: ``fwd`` computes the forward, ``dx``
    the input gradient on flipped weights (both take ``conv3d_fwd``'s
    arguments), ``conv3d_dw`` the filter gradient."""

    @staticmethod
    def forward(ctx, x, w, bias, fwd, dx):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        ctx.dx = dx
        return fwd(x, repack_weight(w, x.dtype), bias.to(x.dtype).contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = ctx.dx(g, flipped_weight(w, g.dtype), None).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = unpack_weight_grad(conv3d_dw(x, g.to(x.dtype))).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum((0, 1, 2, 3)).to(ctx.bias_dtype)
        return dx, dw, db, None, None


def conv3d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
           fwd=conv3d_fwd, dx=conv3d_fwd) -> torch.Tensor:
    """SAME 3³ conv, x NDHWC, w (Co, Ci, 3, 3, 3), bias (Co,); output in
    ``x.dtype``, f32 accumulation.  ``fwd`` and ``dx`` pick the kernels of
    the forward and of the input gradient (default: this module's)."""
    return _Conv3dFn.apply(x, w, bias, fwd, dx)
