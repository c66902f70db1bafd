"""Co=1 SAME 3³ conv (the deep-supervision mask heads): CUDA kernels, their
plain versions and the autograd glue.

Port of ``pcrlv2_tpu/ops/head_conv.py::conv3d_co1_tapmajor`` as selected by
``PCRL_HEADCONV=tapP`` (``_pallas_kernel`` forward, ``_pallas_bwd_kernel``
fused backward).  With the kernel flattened tap-major to ``K (Ci, 27)`` and
``off_t = (td, th, tw)``:

    out[p]   = Σ_t Σ_c x[p + off_t − 1, c] · K[c, t]
    dx[q, c] = Σ_t g(q − off_t + 1) · K[c, t]
    dK[c, t] = Σ_q x[q, c] · g(q − off_t + 1)

all accumulated in f32.  The CUDA source is ``csrc/head_conv.cu``; its header
says what bounds each kernel on the H100 and how the design answers it.  The
bias is added by the caller, outside the kernel (as ``ops/convolution.py``
does in the JAX package).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Channel counts the kernels' 16-byte copies
cannot take (not a multiple of 8 in bf16, of 4 in f32) go through
zero-padded channels (``route``, ``padded_operands``) and the results are
sliced back; up to ``MAX_CI`` channels fit the kernels' shared memory.  The
launch geometry (``tile``, ``fwd_split``, ``bwd_grid``) is worked out here,
where the CPU tests reach it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops import _build
from pcrlv2_tpu_torch.ops.conv3d_kernel import OFFSETS, pad_last, windows

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "head_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "head_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}
TILE = 128      # output voxels of a tile (TH × TW), one thread each
MAX_CI = 512    # channels the kernels' shared memory takes (after padding)
#: channels a stage of the kernels' cp.async rings holds
CHUNK = {torch.bfloat16: 64, torch.float32: 32}
_VEC = {torch.bfloat16: 8, torch.float32: 4}
#: the forward's depth chunks are at least this deep (a chip sweep of 1, 2
#: and 4: f32 is fastest with the most blocks, bf16 with 2)
MIN_PLANES = {torch.bfloat16: 2, torch.float32: 1}
#: blocks an SM of the backward's persistent grid (a chip sweep of 2 and 3)
BWD_BLOCKS_PER_SM = {torch.bfloat16: 3, torch.float32: 2}


def _fn(kind: str, dtype: torch.dtype):
    return _build.entry("head_conv", kind, dtype, _SIGS[kind])


def tile(w: int) -> tuple[int, int]:
    """(TH, TW) of the kernels' tiles: TW follows W (32, 16, 8 or 4)."""
    tw = 32 if w >= 32 else 16 if w >= 16 else 8 if w >= 8 else 4
    return TILE // tw, tw


def n_tiles(b: int, h: int, w: int) -> int:
    """Tiles of one depth plane of every sample."""
    th, tw = tile(w)
    return b * -(-h // th) * -(-w // tw)


def fwd_split(b: int, d: int, h: int, w: int, sms: int, dtype: torch.dtype) -> int:
    """Output planes per block of the forward (#3).  A block walks the depth
    of one tile; where the tiles alone leave the card short of two blocks an
    SM, D is split into chunks of at least ``MIN_PLANES`` planes (each
    re-stages its 2 halo planes), as many as fill one wave."""
    parts = max(1, min(2 * sms // n_tiles(b, h, w), -(-d // MIN_PLANES[dtype])))
    return -(-d // parts)


def bwd_grid(b: int, d: int, h: int, w: int, sms: int, dtype: torch.dtype) -> int:
    """Blocks of the backward's (#4) persistent grid: ``BWD_BLOCKS_PER_SM``
    an SM, at most one a tile.  Fixed for a shape, dtype and card, so dK's
    partials are added in the same order on every run."""
    return min(d * n_tiles(b, h, w), BWD_BLOCKS_PER_SM[dtype] * sms)


def vector_channels(ci: int, dtype: torch.dtype) -> int:
    """Ci rounded up to what the 16-byte copies take."""
    vec = _VEC[dtype]
    return -(-ci // vec) * vec


def route(ci: int, dtype: torch.dtype) -> str:
    """``"vector"`` (x as it is) or ``"padded"`` (zero-padded channels)."""
    return "vector" if vector_channels(ci, dtype) == ci else "padded"


def padded_operands(x: torch.Tensor, k: torch.Tensor, ci: int):
    """x (…, Ci₀) and K (Ci₀, 27) zero-padded to ``ci`` channels."""
    if x.shape[-1] == ci:
        return x, k
    return pad_last(x, ci), F.pad(k, (0, 0, 0, ci - k.shape[0]))


def _check_aligned(x: torch.Tensor, ci: int) -> None:
    if ci > MAX_CI:
        raise ValueError(f"Ci={ci}: the head kernels take at most {MAX_CI} channels")
    if x.data_ptr() % 16:
        raise ValueError("the head kernels need a 16-byte aligned x")


def flatten_kernel(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(1, Ci, 3, 3, 3) → K (Ci, 27), tap-major columns."""
    return w[0].reshape(w.shape[1], 27).to(dtype).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def head_fwd_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, Ci), K (Ci, 27) → (B, D, H, W), f32 accumulation."""
    b, d, h, w, _ = x.shape
    acc = torch.zeros(b * d * h * w, dtype=torch.float32, device=x.device)
    for t, win in windows(x):
        acc += win @ k[:, t].float()
    return acc.reshape(b, d, h, w).to(x.dtype)


def head_bwd_plain(x: torch.Tensor, g: torch.Tensor, k: torch.Tensor):
    """g (B, D, H, W) → (dx like x, dK (Ci, 27) f32)."""
    b, d, h, w, ci = x.shape
    gp = F.pad(g, (1, 1, 1, 1, 1, 1))
    x2 = x.reshape(-1, ci).float()
    dx = torch.zeros(b * d * h * w, ci, dtype=torch.float32, device=x.device)
    dk = torch.empty(ci, 27, dtype=torch.float32, device=x.device)
    for t, (td, th, tw) in enumerate(OFFSETS):
        gw = gp[:, 2 - td:2 - td + d, 2 - th:2 - th + h,
                2 - tw:2 - tw + w].reshape(-1).float()
        dx += gw[:, None] * k[:, t].float()[None, :]
        dk[:, t] = x2.T @ gw
    return dx.reshape(x.shape).to(x.dtype), dk


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def head_fwd(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Co=1 SAME 3³ conv without bias: x (B, D, H, W, Ci), K (Ci, 27) → (B, D, H, W)."""
    b, d, h, w, ci = x.shape
    if k.shape != (ci, 27):
        raise ValueError(f"kernel {tuple(k.shape)} does not fit Ci={ci}")
    if _build.check_inputs(x, k) == "cpu":
        return head_fwd_plain(x, k)
    civ = vector_channels(ci, x.dtype)
    x, k = padded_operands(x, k, civ)
    _check_aligned(x, civ)
    out = torch.empty((b, d, h, w), dtype=x.dtype, device=x.device)
    chunk = fwd_split(b, d, h, w, _build.sm_count(x.device), x.dtype)
    err = _fn("head_fwd", x.dtype)(x.data_ptr(), k.data_ptr(), out.data_ptr(),
                                   b, d, h, w, civ, chunk, _build.stream_ptr(x))
    _build.check(err, "head_fwd launch")
    _build.launches["head_fwd"] += 1
    return out


def head_bwd(x: torch.Tensor, g: torch.Tensor, k: torch.Tensor):
    """Fused backward: g (B, D, H, W) in ``x.dtype`` → (dx, dK (Ci, 27) f32)."""
    b, d, h, w, ci = x.shape
    if g.shape != x.shape[:4] or k.shape != (ci, 27):
        raise ValueError("head_bwd: g must be x's (B, D, H, W), K (Ci, 27)")
    if _build.check_inputs(x, g, k) == "cpu":
        return head_bwd_plain(x, g, k)
    civ = vector_channels(ci, x.dtype)
    x, k = padded_operands(x, k, civ)
    _check_aligned(x, civ)
    grid = bwd_grid(b, d, h, w, _build.sm_count(x.device), x.dtype)
    dx = torch.empty_like(x)
    partial = torch.empty((grid, civ * 27), dtype=torch.float32, device=x.device)
    dk = torch.empty((civ, 27), dtype=torch.float32, device=x.device)
    err = _fn("head_bwd", x.dtype)(
        x.data_ptr(), g.data_ptr(), k.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dk.data_ptr(), b, d, h, w, civ, grid,
        _build.stream_ptr(x))
    _build.check(err, "head_bwd launch")
    _build.launches["head_bwd"] += 1
    if civ != ci:
        return dx[..., :ci].contiguous(), dk[:ci]
    return dx, dk


class _HeadConvFn(torch.autograd.Function):
    """Mirrors ``conv3d_co1_tapmajor``'s custom VJP under ``tapP``."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        k = flatten_kernel(w, x.dtype)
        ctx.save_for_backward(x, k)
        ctx.w_dtype = w.dtype
        return head_fwd(x, k)[..., None]

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        dx, dk = head_bwd(x, g[..., 0].to(x.dtype).contiguous(), k)
        dw = dk.reshape(1, x.shape[-1], 3, 3, 3).to(ctx.w_dtype)
        return dx, dw


def head_conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Co=1 SAME 3³ conv without bias: x NDHWC, w (1, Ci, 3, 3, 3) →
    (B, D, H, W, 1) in ``x.dtype``."""
    return _HeadConvFn.apply(x, w)
