"""Channels-last convolutions of the 3D model (port of
``pcrlv2_tpu/ops/convolution.py``).

Activations are NDHWC; weights keep the reference torch layouts
(Conv3d (Co, Ci, k, k, k), ConvTranspose3d (Ci, Co, k, k, k)).

Dispatch, fixed by shape:

* 3³ SAME stride 1, Co = 1  → the head kernel (``ops/head_conv.py``), bias
  added after it;
* 3³ SAME stride 1, Co > 1  → the conv kernel (``ops/conv3d_kernel.py``),
  the Ci = 1 stem included;
* 1³                        → one (N, Ci) @ (Ci, Co) product;
* k2s2 transpose conv       → one (N, Ci) @ (Ci, Co·8) product and a reshape
  (kernel == stride: the output windows never overlap).
"""

from __future__ import annotations

import torch

from pcrlv2_tpu_torch.ops.conv3d_kernel import conv3d as conv3d_3x3
from pcrlv2_tpu_torch.ops.head_conv import head_conv3d


def conv3d(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """``nn.Conv3d`` (k=3 padding 1, or k=1) over NDHWC; output in ``x.dtype``."""
    co, ci = w.shape[:2]
    k = tuple(w.shape[2:])
    if k == (3, 3, 3):
        if co == 1:
            out = head_conv3d(x, w)
            return out if b is None else out + b.to(out.dtype)
        bias = b if b is not None else torch.zeros(co, dtype=x.dtype,
                                                   device=x.device)
        return conv3d_3x3(x, w, bias)
    if k == (1, 1, 1):
        out = x.reshape(-1, ci) @ w.reshape(co, ci).t().to(x.dtype)
        if b is not None:
            out = out + b.to(out.dtype)
        return out.reshape(*x.shape[:-1], co)
    raise NotImplementedError(f"conv3d kernel size {k} is not ported")


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *,
                     stride: int = 2) -> torch.Tensor:
    """``nn.ConvTranspose3d(k=stride, stride)`` over NDHWC:
    ``out[b, s·d+i, s·h+j, s·w+k, o] = Σ_c x[b, d, h, w, c] · w[c, o, i, j, k]``."""
    ci, co = w.shape[:2]
    if tuple(w.shape[2:]) != (stride,) * 3:
        raise NotImplementedError("only kernel == stride transpose convs are ported")
    bsz, d, h, wd, _ = x.shape
    s = stride
    y = x.reshape(-1, ci) @ w.reshape(ci, co * s ** 3).to(x.dtype)
    y = y.reshape(bsz, d, h, wd, co, s, s, s).permute(0, 1, 5, 2, 6, 3, 7, 4)
    out = y.reshape(bsz, d * s, h * s, wd * s, co)
    if b is not None:
        out = out + b.to(out.dtype)
    return out
