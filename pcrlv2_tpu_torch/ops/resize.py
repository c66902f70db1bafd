"""Interpolation (port of ``pcrlv2_tpu/ops/resize.py``)."""

from __future__ import annotations

import torch


def interp_matrix(n: int, scale: int, device=None) -> torch.Tensor:
    """(n·scale, n) f32 operator of a ×``scale`` linear resample along one
    axis, half-pixel source coordinates clamped at the edges: row o holds
    the two taps of source ``(o + ½)/scale − ½`` (multiples of 1/(2·scale),
    exact in f32).  Built on ``device`` from ``arange``: no host copy."""
    o = torch.arange(n * scale, dtype=torch.float32, device=device)
    src = torch.clamp((o + 0.5) / scale - 0.5, 0.0, n - 1.0)
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.clamp(1.0 - torch.abs(src[:, None] - i[None, :]), min=0.0)


def upsample_nearest2x_2d(x: torch.Tensor) -> torch.Tensor:
    """×2 nearest upsample of NHWC (torch ``mode='nearest'``), as a broadcast
    and a reshape: its gradient sums each 2×2 block, in a fixed order (an
    index-based repeat's backward would add with atomics on the card)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def upsample_linear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bi- or trilinear ×``scale`` upsample of NHWC / NDHWC with half-pixel source
    coordinates (``align_corners=False``), the same map as
    ``jax.image.resize(method='linear')`` at an integer scale and, like it,
    one axis at a time: a product with ``interp_matrix`` per axis, in f32.
    Products, not ``F.interpolate``: its CUDA backward adds with atomics in
    no fixed order, so two runs of a step would differ in the last bits."""
    if scale == 1:
        return x
    y = x.float()
    for axis in range(1, x.ndim - 1):
        w = interp_matrix(y.shape[axis], scale, y.device)
        y = torch.movedim(torch.movedim(y, axis, -1) @ w.t(), -1, axis)
    return y.to(x.dtype)
