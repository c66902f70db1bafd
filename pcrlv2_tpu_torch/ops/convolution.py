"""Channels-last convolutions (port of ``pcrlv2_tpu/ops/convolution.py``).

Activations are NDHWC / NHWC; weights keep the reference torch layouts
(Conv3d (Co, Ci, k, k, k), ConvTranspose3d (Ci, Co, k, k, k), Conv2d
(Co, Ci, k, k)).

The 2D convs of the chest model are XLA's in the JAX package
(``lax.conv_general_dilated``), not a Pallas kernel, so here they are
cuDNN's (``conv2d``), fed channels-last strides; ``deterministic_cudnn``
sets what their CUDA graphs and f32 parity need.

Dispatch, by shape and ``PCRL_CONV3D`` (``conv_impl``):

* 3³ SAME stride 1, Co = 1  → the head kernel (``ops/head_conv.py``), bias
  added after it, whatever ``PCRL_CONV3D`` says (so the port's ``packed``
  is the JAX package's ``PCRL_CONV3D=packed PCRL_HEADCONV=tapP``);
* 3³ SAME stride 1, Co > 1  → the conv kernels of the selected
  implementation, the Ci = 1 stem included: ``pallas`` (the default)
  ``ops/conv3d_kernel.py``, ``packed`` and ``im2col``
  ``ops/conv3d_packed.py``;
* 1³                        → one (N, Ci) @ (Ci, Co) product;
* k2s2 transpose conv       → one (N, Ci) @ (Ci, Co·8) product and a reshape
  (kernel == stride: the output windows never overlap).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops.conv3d_kernel import conv3d as conv3d_pallas
from pcrlv2_tpu_torch.ops.conv3d_packed import conv3d_im2col, conv3d_packed
from pcrlv2_tpu_torch.ops.head_conv import head_conv3d

#: ``PCRL_CONV3D`` value → the 3³ conv (Co > 1) it selects
CONV3D_IMPLS = {"pallas": conv3d_pallas, "packed": conv3d_packed,
                "im2col": conv3d_im2col}


def conv_impl() -> str:
    """The 3³ conv implementation ``PCRL_CONV3D`` selects, read at each call
    (as ``pcrlv2_tpu/ops/convolution.py:40-58``): unset or ``pallas`` (the
    default), ``packed`` or ``im2col``.  Any other value raises: the port
    has no library conv to stand for the JAX package's ``xla``, and
    ``auto``'s win set is a TPU measurement."""
    impl = (os.environ.get("PCRL_CONV3D") or "pallas").lower()
    if impl not in CONV3D_IMPLS:
        raise ValueError(
            f"PCRL_CONV3D={impl!r} is not an implementation of the port: use "
            f"pallas (the default), packed or im2col")
    return impl


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
        return CONV3D_IMPLS[conv_impl()](x, w, bias)
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


def deterministic_cudnn() -> None:
    """cuDNN as the 2D path needs it, for the whole process (a conv's
    backward runs on autograd's thread, outside any context manager):
    deterministic algorithms, so a CUDA graph's replay equals the eager
    step bit for bit; no autotuning (``benchmark``), which would pick by
    timing; and no TF32, so an f32 conv is f32 (a bf16 one is unaffected)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1) -> torch.Tensor:
    """``nn.Conv2d(k, stride, padding=k//2)`` over NHWC ``x``, weight (Co, Ci,
    k, k) cast to ``x.dtype``; the bias is added after the conv, in the
    output's dtype (as ``pcrlv2_tpu/ops/convolution.py:146``).  ``x``
    permuted to NCHW has channels-last strides, so cuDNN reads it as it lies
    and its output, permuted back, is NHWC without a copy."""
    k = w.shape[-1]
    out = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=stride,
                   padding=k // 2).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.to(out.dtype)
    return out
