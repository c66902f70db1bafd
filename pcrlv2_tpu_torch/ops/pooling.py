"""Pooling over NDHWC / NHWC (port of ``pcrlv2_tpu/ops/pooling.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2³ stride-2 max pool.  The gradient goes to the FIRST max of each
    window in (d, h, w) order, as in the JAX package's select-and-scatter
    backward: ties are common after ReLU (zeros)."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 4, 1)


def max_pool2d(x: torch.Tensor) -> torch.Tensor:
    """The ResNet stem's 3×3 stride-2 max pool of NHWC, padded by 1 with −inf
    (torch semantics).  The windows overlap, so an input can take gradient
    from several of them; in each window it goes to the FIRST max in (h, w)
    order, as the JAX package's ``reduce_window`` gradient does (ties are
    common after ReLU)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, *spatial, C) → (B, C); the mean accumulates in f32."""
    return x.float().mean(dim=tuple(range(1, x.ndim - 1))).to(x.dtype)
