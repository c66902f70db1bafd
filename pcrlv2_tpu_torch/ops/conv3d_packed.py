"""SAME 3³ conv3d fed from a staged slab: the tw-packed and im2col kernels,
their plain versions and the autograd glue.

Port of ``pcrlv2_tpu/ops/pallas_conv.py::conv3d_packed`` (``_packed_kernel``)
and ``::conv3d_im2col`` (``_im2col_kernel``).  Both compute what
``conv3d_kernel.conv3d_fwd`` computes; the CUDA source is
``csrc/conv3d_packed.cu``, whose header says what bounds the kernels and how
the tiling answers it.  Weights come as ``conv3d_kernel.repack_weight``'s
(27, Ci, Co) buffer, which is also the TPU kernels' ``w9`` (9, 3·Ci, Co) and
``wmat`` (27·Ci, Co).

* ``conv3d_packed``: forward and dx (on flipped, io-swapped weights) by the
  packed kernel, dw by ``conv3d_kernel.conv3d_dw`` (the JAX package leaves
  dw to XLA's transpose), db a sum in f32 (``pallas_conv.py:442-473``);
* ``conv3d_im2col``: forward by the im2col kernel, dx by
  ``conv3d_kernel.conv3d_fwd`` on flipped weights and dw by ``conv3d_dw``
  (XLA transposes in JAX, ``pallas_conv.py:476-508``).

On the card both kernels take 128-voxel × N-channel tiles (``tiles``,
N = ``conv3d_kernel.fwd_tile``) and walk K in stages of one depth tap and
one channel chunk (``stages``), split where the grid is short of the card
(``split``); ``route`` says which shapes run on zero-padded channels.  The
kernel template (``csrc/slab_conv.cuh``) also runs the prototype tool's
CONCAT27 and CONCAT9 convs (#7, ``tools/proto_conv.py``), launched by the
same ``launch``; ``MODE`` says which slab layout and stage order each
kernel kind takes.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  It never falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops import _build
from pcrlv2_tpu_torch.ops import conv3d_kernel as ck

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = (_P,) * 5 + (_I,) * 15 + (_P,)
_BM = 128     # the kernels' output rows (voxels) per block
_STAGES = 2   # depth of the kernels' shared-memory ring
#: per dtype: (input channels per stage, row pad in elements)
_SLAB = {torch.bfloat16: (16, 8), torch.float32: (8, 4)}
#: shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
#: each kernel kind's mode of the template: its slab layout ("packed", the
#: three tw shifts side by side; "im2col", a depth plane with its h/w halo)
#: and stage order ("packed" and "im2col_td" depth tap outer, "im2col" the
#: channel chunks outer)
MODE = {"conv3d_packed": "packed", "conv3d_im2col": "im2col",
        "proto_conv27": "im2col", "proto_conv9": "im2col_td"}


def tiles(b: int, d: int, h: int, w: int, bm: int = _BM) -> dict:
    """How the kernels cut the output into blocks of ``bm`` voxels: planes
    of at least ``bm`` voxels in ``tpp`` segments of ``L = bm`` consecutive
    positions (``P = 1``); smaller planes ``P = bm // (h·w)`` whole to a
    block (``L = h·w``).  ``rows`` is the most input rows of one plane an
    im2col block stages, halo included."""
    hw = h * w
    if hw >= bm:
        p, seg, tpp = 1, bm, math.ceil(hw / bm)
        n = b * d * tpp
        rows = (w + bm - 2) // w + 3
    else:
        p, seg, tpp = bm // hw, hw, 1
        n = math.ceil(b * d / p)
        rows = h + 2
    return {"P": p, "L": seg, "tpp": tpp, "tiles": n, "rows": rows}


def slab_rows(kind: str, geo: dict, w: int) -> int:
    """Slab rows of one stage: packed, ``L + 2W`` plane positions per
    segment (the output rows and a row of halo above and below); im2col,
    ``rows`` input rows of ``W + 2`` positions per plane."""
    if MODE[kind] == "packed":
        return geo["P"] * (geo["L"] + 2 * w)
    return geo["P"] * geo["rows"] * (w + 2)


def smem_bytes(kind: str, geo: dict, w: int, bn: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block: ``_STAGES`` slabs (rows of
    ``3·BK`` packed or ``BK`` im2col channels, padded) and weight tiles (9
    taps × BK × ``bn`` columns, padded), plus the slab's row table."""
    bk, pad = _SLAB[dtype]
    es = torch.tensor([], dtype=dtype).element_size()
    rows = slab_rows(kind, geo, w)
    lds = (3 if MODE[kind] == "packed" else 1) * bk + pad
    return es * _STAGES * (rows * lds + 9 * bk * (bn + pad)) + 8 * rows


def stages(kind: str, ci: int, dtype: torch.dtype) -> list:
    """The K walk of one block as (td, first channel) per stage, in order:
    packed and im2col_td, td outer and the Ci chunks inner; im2col, the
    chunks outer and td inner.  Each stage covers taps 9·td .. 9·td + 8 of
    its channels."""
    bk = _SLAB[dtype][0]
    chunks = range(0, ci, bk)
    if MODE[kind] != "im2col":
        return [(td, c0) for td in range(3) for c0 in chunks]
    return [(td, c0) for c0 in chunks for td in range(3)]


def split(tiles_mn: int, nst: int, sms: int) -> tuple[int, int]:
    """(splits, stages per split) of a block's ``nst`` stages: where the
    grid of ``tiles_mn`` (row, column) tiles has fewer than two blocks per
    SM, split the stages so it has about two, each split at least two
    stages deep."""
    s = 1 if tiles_mn >= 2 * sms else max(1, min(math.ceil(2 * sms / tiles_mn), nst // 2))
    per = math.ceil(nst / s)
    return math.ceil(nst / per), per


def route(ci: int, co: int, dtype: torch.dtype) -> str:
    """``"vector"``: Ci and Co are multiples of the 16-byte copy's width (8
    bf16, 4 f32) and the kernels take the tensors as they are;
    ``"padded"``: any other shape, the stem (Ci = 1) included, runs the same
    kernels on channels zero-padded to those multiples
    (``conv3d_kernel.padded_operands``) and is sliced back."""
    return "vector" if ck.vector_channels(ci, co, dtype, stem=False) == (ci, co) else "padded"


# ---------------------------------------------------------------------------
# plain versions (CPU path and the card-side reference)
# ---------------------------------------------------------------------------


def conv3d_packed_plain(x: torch.Tensor, wmat: torch.Tensor,
                        bias: torch.Tensor | None) -> torch.Tensor:
    """``bias + Σ_{td,th} window_th(packed_td) @ w9[3·td + th]`` in f32: for
    each depth tap the three tw shifts side by side, ``packed_td`` ((H+2)·W
    rows of 3·Ci), and the th windows as row offsets th·W of it."""
    b, d, h, w, ci = x.shape
    co = wmat.shape[-1]
    w9 = wmat.reshape(9, 3 * ci, co).float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)).float()
    acc = torch.zeros(b, d, h * w, co, dtype=torch.float32, device=x.device)
    if bias is not None:
        acc += bias.float()
    for td in range(3):
        plane = xp[:, td:td + d]
        packed = torch.cat([plane[:, :, :, tw:tw + w] for tw in range(3)], -1)
        packed = packed.reshape(b, d, (h + 2) * w, 3 * ci)
        for th in range(3):
            acc += packed[:, :, th * w:th * w + h * w] @ w9[3 * td + th]
    return acc.reshape(b, d, h, w, co).to(x.dtype)


def conv3d_im2col_plain(x: torch.Tensor, wmat: torch.Tensor,
                        bias: torch.Tensor | None) -> torch.Tensor:
    """``bias + cols @ wmat.reshape(27·Ci, Co)`` in f32, ``cols`` the 27 tap
    windows side by side (N, 27·Ci), tap-major as the reshape orders it."""
    b, d, h, w, ci = x.shape
    co = wmat.shape[-1]
    cols = torch.cat([win for _, win in ck.windows(x)], -1)
    out = cols @ wmat.reshape(27 * ci, co).float()
    if bias is not None:
        out += bias.float()
    return out.reshape(b, d, h, w, co).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def launch(kind: str, plain, x: torch.Tensor, wmat: torch.Tensor,
           bias: torch.Tensor | None, lib: str = "conv3d_packed") -> torch.Tensor:
    """The template's kernel ``kind`` (the C entry ``<kind>_<dtype>`` of
    ``csrc/<lib>.cu``, counted under ``kind``) on x (B, D, H, W, Ci), wmat
    (27, Ci, Co), bias (Co,) or None; ``plain(x, wmat, bias)`` for CPU
    tensors."""
    b, d, h, w, ci = x.shape
    if wmat.shape[:2] != (27, ci):
        raise ValueError(f"weights {tuple(wmat.shape)} do not fit Ci={ci}")
    co = wmat.shape[2]
    tensors = (x, wmat) if bias is None else (x, wmat, bias)
    if _build.check_inputs(*tensors) == "cpu":
        return plain(x, wmat, bias)
    if x.numel() == 0:
        raise ValueError(f"{kind} takes a non-empty input, got {tuple(x.shape)}")
    ci_p, co_p = ck.vector_channels(ci, co, x.dtype, stem=False)
    x, wmat, bias = ck.padded_operands(x, wmat, bias, ci_p, co_p)
    ck.check_vectors((x, wmat), ci_p, co_p)
    geo = tiles(b, d, h, w)
    bn = ck.fwd_tile(ci_p, co_p)
    smem = smem_bytes(kind, geo, w, bn, x.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kind}: W={w} needs {smem} bytes of shared memory "
                         f"per block, more than the {SMEM_LIMIT} a block has")
    nst = len(stages(kind, ci_p, x.dtype))
    s, per = split(geo["tiles"] * math.ceil(co_p / bn), nst, ck._sms(x))
    out = torch.empty((b, d, h, w, co_p), dtype=x.dtype, device=x.device)
    partial = (torch.empty((s, b * d * h * w, co_p), dtype=torch.float32, device=x.device)
               if s > 1 else None)
    err = _build.entry(lib, kind, x.dtype, _SIG)(
        x.data_ptr(), wmat.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        b, d, h, w, ci_p, co_p, geo["P"], geo["L"], geo["tpp"], geo["rows"],
        slab_rows(kind, geo, w), geo["tiles"], bn, s, per, _build.stream_ptr(x))
    _build.check(err, f"{kind} launch")
    _build.launches[kind] += 1
    return out if co_p == co else out[..., :co].contiguous()


def conv3d_packed_fwd(x: torch.Tensor, wmat: torch.Tensor,
                      bias: torch.Tensor | None) -> torch.Tensor:
    """SAME 3³ conv by the packed kernel: x (B, D, H, W, Ci), wmat
    (27, Ci, Co), bias (Co,) or None, all of one dtype → (B, D, H, W, Co)."""
    return launch("conv3d_packed", conv3d_packed_plain, x, wmat, bias)


def conv3d_im2col_fwd(x: torch.Tensor, wmat: torch.Tensor,
                      bias: torch.Tensor | None) -> torch.Tensor:
    """SAME 3³ conv by the im2col kernel; arguments as ``conv3d_packed_fwd``."""
    return launch("conv3d_im2col", conv3d_im2col_plain, x, wmat, bias)


def conv3d_packed(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """SAME 3³ conv, x NDHWC, w (Co, Ci, 3, 3, 3), bias (Co,): forward and
    dx by the packed kernel."""
    return ck.conv3d(x, w, bias, fwd=conv3d_packed_fwd, dx=conv3d_packed_fwd)


def conv3d_im2col(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """SAME 3³ conv, x NDHWC, w (Co, Ci, 3, 3, 3), bias (Co,): forward by
    the im2col kernel, dx by ``conv3d_kernel.conv3d_fwd``."""
    return ck.conv3d(x, w, bias, fwd=conv3d_im2col_fwd, dx=ck.conv3d_fwd)
