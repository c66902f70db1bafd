"""Interpolation (port of ``pcrlv2_tpu/ops/resize.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_linear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Trilinear ×``scale`` upsample of NDHWC with half-pixel source
    coordinates (``align_corners=False``), the same map as
    ``jax.image.resize(method='linear')`` at an integer scale."""
    if scale == 1:
        return x
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), scale_factor=scale,
                      mode="trilinear", align_corners=False)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)
