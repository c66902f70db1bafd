"""Pooling over NDHWC (port of ``pcrlv2_tpu/ops/pooling.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2³ stride-2 max pool.  The gradient goes to the FIRST max of each
    window in (d, h, w) order, as in the JAX package's select-and-scatter
    backward: ties are common after ReLU (zeros)."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 4, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) → (B, C); the mean accumulates in f32."""
    return x.float().mean(dim=(1, 2, 3)).to(x.dtype)
