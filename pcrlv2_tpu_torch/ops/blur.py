"""Separable Gaussian blur as banded-matrix products (port of
``pcrlv2_tpu/ops/blur.py``), batched over a leading sample axis: reflect
padding for the 3D stack (scipy's ``gaussian_filter``), edge padding for the
2D one (PIL's ``GaussianBlur``).

The 1-D pass along an axis of length n is one (n, n) banded operator whose
boundary columns fold in the padding mode, so a blur is a matrix product
rather than a 17-wide sliding-window gather.
"""

from __future__ import annotations

import torch

#: fixed 17-tap kernel ≈ scipy truncate=4 at σ_max=2
BLUR_RADIUS = 8


def gaussian_kernel(sigma: torch.Tensor, radius: int = BLUR_RADIUS) -> torch.Tensor:
    """Normalized Gaussian taps for each σ in ``sigma`` (N,) → (N, 2r+1);
    a delta for σ → 0."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    s = sigma.float()[:, None]
    w = torch.exp(-0.5 * (x / torch.clamp(s, min=1e-6)) ** 2)
    w = torch.where(s < 1e-4, (x == 0).float().expand_as(w), w)
    return w / w.sum(dim=1, keepdim=True)


def tap_sources(n: int, taps: int, device=None, pad_mode: str = "reflect") -> torch.Tensor:
    """(taps, n) source index of tap k for output o, the padding folded in:
    ``reflect`` (scipy's convention, no edge duplication) or ``edge`` (the
    nearest pixel); built on ``device`` from ``arange`` (no host copy, so a
    CUDA graph can capture it)."""
    r = (taps - 1) // 2
    o = torch.arange(n, device=device)
    src = o[None, :] - r + torch.arange(taps, device=device)[:, None]
    if pad_mode == "edge":
        return src.clamp(0, n - 1)
    src = torch.abs(src)
    src = torch.where(src >= n, 2 * (n - 1) - src, src)
    # axes shorter than the radius + 1 reflect past the far edge to −1…;
    # wrap those the way the JAX package's indexed add does
    return src % n


def band_matrix(n: int, kernel: torch.Tensor, pad_mode: str = "reflect") -> torch.Tensor:
    """(N, taps) kernels → (N, n, n) operators ``W[o, s] = Σ_k kernel[k]·[src_k(o) == s]``."""
    taps = kernel.shape[1]
    src = tap_sources(n, taps, kernel.device, pad_mode)
    onehot = torch.zeros(taps, n, n, dtype=kernel.dtype, device=kernel.device)
    onehot.scatter_add_(2, src[:, :, None],
                        torch.ones(taps, n, 1, dtype=kernel.dtype,
                                   device=kernel.device))
    return torch.einsum("bk,kos->bos", kernel, onehot)


def blur_axis(img: torch.Tensor, kernel: torch.Tensor, axis: int,
              pad_mode: str = "reflect") -> torch.Tensor:
    """1-D convolution of each sample of ``img`` (N, ...) along spatial
    ``axis`` (0-based, after the sample axis) with its own taps (N, taps)."""
    n = img.shape[axis + 1]
    w = band_matrix(n, kernel, pad_mode)
    moved = torch.movedim(img, axis + 1, -1)
    out = torch.einsum("bos,b...s->b...o", w, moved)
    return torch.movedim(out, -1, axis + 1)
