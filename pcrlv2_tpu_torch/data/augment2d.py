"""2D augmentation on the device (port of ``pcrlv2_tpu/data/augment2d.py``;
reference torchvision/PIL stack ``data.py:14-44``, ``chestDataset.py:31-48``).

Per image of a batch:

* 2 global views: RandomResizedCrop(224, scale (0.3, 1)) → RandomRotation(10)
  → RandomHorizontalFlip;
* 6 local views: RandomResizedCrop(96, scale (0.05, 0.3)) → rotation → flip;
* the global views, normalized but not corrupted, are the restoration
  targets ``gt`` / ``gt2``;
* corruption: RandomGrayscale(0.2) → GaussianBlur(σ ∈ [0.1, 2], p = 0.5,
  edge padding) → ColorJitter(0.4 × 4, fixed order) → Normalize(ImageNet)
  → Cutout(3 holes of 32 px; global views only).

Every function works on a batch of views (N, C, H, W), each view with its
own parameters.  The deterministic pieces take their parameters as
arguments (``crop_box``, ``crop_and_resize``, ``shear``, ``rotate_shear``,
``rotate_exact``, ``hflip``, ``grayscale``, ``gaussian_blur_2d``,
``color_jitter``, ``normalize_imagenet``, ``cutout``), so tests hold them to
the JAX package on the same parameters; the ``random_*`` functions and
``sample_resized_crop_box`` draw them from an explicit ``torch.Generator``.
The rotation resamples by 3 shears with linear interpolation
(``rotate_shear``, the default) or by one nearest gather (``rotate_exact``,
torchvision's semantics), chosen by ``PCRL_ROTATE`` (``rotate_impl``).

Written for CUDA graphs, as ``augment3d``: parameters drawn on the device,
index tables built from ``arange`` on the device, every launch made
whatever the draws (a blur or a flip is computed for every view and
selected with ``torch.where``), nothing read back to the host.  The crop box
takes the first valid of 10 fixed attempts, as the JAX package does: no
host loop.

A grey source (C = 1) stays one channel through the crop, rotation and flip,
which treat channels alike, and is broadcast to RGB after them: what the JAX
package computes on the broadcast image, for a third of the work.
"""

from __future__ import annotations

import math
import os

import torch

from pcrlv2_tpu_torch.ops.blur import blur_axis, gaussian_kernel

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
#: torchvision's RandomResizedCrop aspect range
RATIO = (3.0 / 4.0, 4.0 / 3.0)
#: the fixed number of crop-box attempts (torchvision tries up to 10)
ATTEMPTS = 10

# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------


def crop_box(target_area: torch.Tensor, log_ratio: torch.Tensor, corner: torch.Tensor,
             img_hw, ratio=RATIO):
    """torchvision ``RandomResizedCrop.get_params`` on given draws: per view
    (N, attempts) target areas and log aspect ratios and (N, 2, attempts)
    corner fractions; the first valid attempt wins, else the aspect-clamped
    centre crop.  Returns (i, j, h, w), each (N,), in (float) pixels."""
    h_img, w_img = img_hw
    aspect = torch.exp(log_ratio)
    w = torch.sqrt(target_area * aspect)
    h = torch.sqrt(target_area / aspect)
    valid = (w <= w_img) & (h <= h_img) & (w >= 1) & (h >= 1)
    i = corner[:, 0] * (h_img - h)
    j = corner[:, 1] * (w_img - w)
    # argmax returns the first of equal maxima: the first valid attempt
    first = valid.to(torch.int32).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    in_ratio = w_img / h_img
    fw = h_img * ratio[1] if in_ratio > ratio[1] else w_img
    fh = w_img / ratio[0] if in_ratio < ratio[0] else h_img
    fallback = ((h_img - fh) / 2.0, (w_img - fw) / 2.0, fh, fw)
    return tuple(torch.where(any_valid, v.gather(1, first).squeeze(1),
                             torch.full_like(any_valid, f, dtype=v.dtype))
                 for v, f in zip((i, j, h, w), fallback))


def sample_resized_crop_box(gen: torch.Generator, n: int, img_hw, scale, ratio=RATIO):
    """Draw ``n`` crop boxes (``crop_box``) on ``gen``'s device: area
    fractions U(``scale``), log aspect U(log ``ratio``), corners U(0, 1),
    ``ATTEMPTS`` each."""
    dev = gen.device
    area = img_hw[0] * img_hw[1]

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    target = area * uniform((n, ATTEMPTS), scale[0], scale[1])
    log_ratio = uniform((n, ATTEMPTS), math.log(ratio[0]), math.log(ratio[1]))
    corner = torch.rand(n, 2, ATTEMPTS, generator=gen, device=dev)
    return crop_box(target, log_ratio, corner, img_hw, ratio)


def resize_matrix(out_n: int, in_n: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """(N, out_n, in_n): per view, the 1-D linear resize with antialiasing of
    ``jax.image.scale_and_translate`` (``pcrlv2_tpu/data/augment2d.py:95``):
    output o samples input ``(o + ½ − translation)/scale − ½`` with a
    triangle kernel widened by 1/scale when downscaling, rows normalized."""
    dev = scale.device
    o = torch.arange(out_n, dtype=torch.float32, device=dev)
    x = (o[None, :] + 0.5 - translation[:, None]) / scale[:, None] - 0.5
    i = torch.arange(in_n, dtype=torch.float32, device=dev)
    s = torch.clamp(scale, max=1.0)[:, None, None]
    w = torch.clamp(1.0 - torch.abs((i[None, None, :] - x[..., None]) * s), min=0.0)
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-12)


def crop_and_resize(img: torch.Tensor, box, out_size: int) -> torch.Tensor:
    """Each source image's boxes resized to ``out_size``² (the PIL-resize
    equivalent), as two products with ``resize_matrix``: ``img`` (B, C, H,
    W), ``box`` = (i, j, h, w) each (B, V) → (B, V, C, out, out)."""
    i, j, h, w = box
    b, v = i.shape
    sh, sw = out_size / h, out_size / w
    wh = resize_matrix(out_size, img.shape[2], sh.reshape(-1), (-i * sh).reshape(-1))
    ww = resize_matrix(out_size, img.shape[3], sw.reshape(-1), (-j * sw).reshape(-1))
    t = torch.einsum("bvoh,bchw->bvcow", wh.reshape(b, v, out_size, -1), img)
    return torch.einsum("bvpw,bvcow->bvcop", ww.reshape(b, v, out_size, -1), t)


def shear(img: torch.Tensor, axis: int, lam: torch.Tensor) -> torch.Tensor:
    """Re-read spatial ``axis`` (0: H, per column; 1: W, per row) of each view
    at ``x_k + λ·(x_j − c_j)`` with linear interpolation and zero fill — the
    JAX package's ``_unit_shear`` (there by bit-decomposed rolls), here as
    two gathers: ``(1 − f)·img[s] + f·img[s + 1]``, taps outside the image 0."""
    n, c, hh, ww = img.shape
    n_k, n_j = (hh, ww) if axis == 0 else (ww, hh)
    dev = img.device
    jc = torch.arange(n_j, dtype=torch.float32, device=dev) - (n_j - 1) / 2.0
    t = lam[:, None] * jc
    s = torch.floor(t)
    f = t - s
    k = torch.arange(n_k, dtype=torch.float32, device=dev)
    if axis == 0:
        src, f = k[None, :, None] + s[:, None, :], f[:, None, None, :]
    else:
        src, f = s[:, :, None] + k[None, None, :], f[:, None, :, None]

    def tap(pos):
        ok = (pos >= 0) & (pos <= n_k - 1)
        idx = pos.clamp(0, n_k - 1).long()[:, None].expand(n, c, hh, ww)
        return torch.where(ok[:, None], img.gather(2 + axis, idx), 0.0)

    return (1.0 - f) * tap(src) + f * tap(src + 1)


def rotate_shear(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotation by θ (N,) radians about the centre as three shears,
    R(θ) = Shy(−tan θ/2)·Shx(sin θ)·Shy(−tan θ/2), linear interpolation
    (the JAX package's default ``_rotate_shear``)."""
    a = -torch.tan(theta / 2.0)
    img = shear(img, 0, a)
    img = shear(img, 1, torch.sin(theta))
    return shear(img, 0, a)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, halves away from zero (exact in f32)."""
    a = torch.abs(x)
    fl = torch.floor(a)
    return torch.sign(x) * (fl + (a - fl >= 0.5).to(x.dtype))


def rotate_exact(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotation by θ (N,) about the centre by one nearest gather, zero fill:
    torchvision ``RandomRotation``'s semantics (the JAX package's
    ``_rotate_exact``, ``map_coordinates`` at order 0: coordinates rounded
    half away from zero)."""
    n, c, h, w = img.shape
    dev = img.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    sy = _round_half_away(cos * yy - sin * xx + cy)
    sx = _round_half_away(sin * yy + cos * xx + cx)
    ok = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    lin = (sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)).long().reshape(n, 1, -1)
    out = img.reshape(n, c, -1).gather(2, lin.expand(n, c, -1)).reshape(n, c, h, w)
    return torch.where(ok[:, None], out, 0.0)


#: values of ``PCRL_ROTATE``
ROTATE_IMPLS = ("shear", "exact")


def rotate_impl() -> str:
    """``PCRL_ROTATE``: ``shear`` (default, ``rotate_shear``) or ``exact``
    (``rotate_exact``); any other value raises."""
    impl = os.environ.get("PCRL_ROTATE", "shear").lower()
    if impl not in ROTATE_IMPLS:
        raise ValueError(f"PCRL_ROTATE={impl!r}: expected one of {ROTATE_IMPLS}")
    return impl


def hflip(img: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Flip W of the views where ``do`` (N,) is true."""
    return torch.where(do[:, None, None, None], img.flip(3), img)


def random_spatial(gen: torch.Generator, img: torch.Tensor, views: int, out_size: int,
                   scale, degrees: float = 10.0, impl: str | None = None) -> torch.Tensor:
    """``views`` random views of each image of ``img`` (B, C, H, W): resized
    crop → rotation U(±``degrees``) → horizontal flip p = 0.5 (reference
    ``data.py:19-29``) → (B·views, C, out, out), sample-major."""
    b, dev = img.shape[0], img.device
    n = b * views
    box = sample_resized_crop_box(gen, n, img.shape[2:], scale)
    v = crop_and_resize(img, tuple(t.reshape(b, views) for t in box), out_size)
    v = v.reshape(n, *v.shape[2:])
    theta = ((torch.rand(n, generator=gen, device=dev) * 2 - 1) * degrees) * (math.pi / 180.0)
    rotate = rotate_exact if (impl or rotate_impl()) == "exact" else rotate_shear
    v = rotate(v, theta)
    return hflip(v, torch.rand(n, generator=gen, device=dev) < 0.5)


# ---------------------------------------------------------------------------
# intensity
# ---------------------------------------------------------------------------


def _per_view(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, None, None]


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma of (N, 3, H, W) → (N, 1, H, W)."""
    return (0.299 * img[:, 0] + 0.587 * img[:, 1] + 0.114 * img[:, 2])[:, None]


def grayscale(img: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The luma in every channel of the views where ``do`` (N,) is true."""
    return torch.where(_per_view(do), rgb_to_gray(img).expand_as(img), img)


def gaussian_blur_2d(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of each view with its σ (N,), edge padding, 17
    taps (PIL ``GaussianBlur``, reference ``utils.py:139-148``)."""
    w = gaussian_kernel(sigma)
    return blur_axis(blur_axis(img, w, 1, "edge"), w, 2, "edge")


def _rgb_to_hsv(img: torch.Tensor):
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    # grey pixels (every pixel of a grey source) take the zero branches
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, h)
    return torch.remainder(h / 6.0, 1.0), s, maxc


def _hsv_to_rgb(h, s, v) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=1)


def color_jitter(img: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
                 fs: torch.Tensor, fh: torch.Tensor) -> torch.Tensor:
    """torchvision ``ColorJitter`` with per-view factors (N,) in a fixed order
    (the JAX package's deviation: torchvision shuffles it): brightness
    ``fb``, contrast ``fc`` about the mean luma, saturation ``fs`` about the
    luma, hue shift ``fh`` through HSV; each clipped to [0, 1]."""
    img = torch.clamp(img * _per_view(fb), 0.0, 1.0)
    mean = rgb_to_gray(img).mean(dim=(1, 2, 3))
    img = torch.clamp((img - _per_view(mean)) * _per_view(fc) + _per_view(mean), 0.0, 1.0)
    gray = rgb_to_gray(img)
    img = torch.clamp((img - gray) * _per_view(fs) + gray, 0.0, 1.0)
    h, s, v = _rgb_to_hsv(img)
    img = _hsv_to_rgb(torch.remainder(h + fh[:, None, None], 1.0), s, v)
    return torch.clamp(img, 0.0, 1.0)


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(img − mean) / std per RGB channel of (N, 3, H, W), the statistics as
    Python numbers (a tensor made from host values would be a host-to-device
    copy inside the step)."""
    return torch.stack([(img[:, c] - m) / s for c, (m, s) in
                        enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))], dim=1)


def cutout(img: torch.Tensor, centers: torch.Tensor, length: int = 32) -> torch.Tensor:
    """Reference ``Cutout`` (``utils.py:60-98``): zero the squares of side
    ``length`` centred at ``centers`` (N, holes, 2) (y, x), clipped at the
    borders."""
    h, w = img.shape[2:]
    yy = torch.arange(h, device=img.device)[None, :, None]
    xx = torch.arange(w, device=img.device)[None, None, :]
    keep = torch.ones((img.shape[0], h, w), dtype=torch.bool, device=img.device)
    for k in range(centers.shape[1]):
        cy, cx = centers[:, k, 0, None, None], centers[:, k, 1, None, None]
        hole = ((yy >= cy - length // 2) & (yy < cy + length // 2)
                & (xx >= cx - length // 2) & (xx < cx + length // 2))
        keep = keep & ~hole
    return img * keep[:, None].to(img.dtype)


def random_corrupt(gen: torch.Generator, img: torch.Tensor, with_cutout: bool,
                   n_holes: int = 3) -> torch.Tensor:
    """RandomGrayscale(0.2) → blur (σ ~ U(0.1, 2), p = 0.5) → ColorJitter(0.4
    each) → Normalize [→ Cutout] (reference ``data.py:30-44``) of (N, 3, H, W)."""
    n, dev = img.shape[0], img.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    img = grayscale(img, torch.rand(n, generator=gen, device=dev) < 0.2)
    sigma = uniform(0.1, 2.0)
    blurred = gaussian_blur_2d(img, sigma)
    img = torch.where(_per_view(torch.rand(n, generator=gen, device=dev) < 0.5), blurred, img)
    img = color_jitter(img, uniform(0.6, 1.4), uniform(0.6, 1.4), uniform(0.6, 1.4),
                       uniform(-0.4, 0.4))
    img = normalize_imagenet(img)
    if with_cutout:
        u = torch.rand(n, n_holes, 2, generator=gen, device=dev)
        centers = torch.stack([u[..., 0] * img.shape[2], u[..., 1] * img.shape[3]], -1).long()
        img = cutout(img, centers)
    return img


# ---------------------------------------------------------------------------
# batch augmentation
# ---------------------------------------------------------------------------


def make_chest_aug_fn(n_local: int = 6, global_size: int = 224, local_size: int = 96):
    """Batch augmentation of the 2D pipeline (reference
    ``chestDataset.py:31-48``).

    Input ``{'image': (B, canvas, canvas, C)}`` on the target device: uint8
    (divided by 255) or float in [0, 1], C = 1 (a grey source) or 3.  Output
    views, ImageNet-normalized: ``x1``, ``x2``, ``gt``, ``gt2`` (B, 224, 224,
    3) and ``locals`` (B, 6, 96, 96, 3).  ``gt``/``gt2`` are the spatially
    augmented, uncorrupted global views.
    """

    def aug_fn(gen: torch.Generator, batch):
        imgs = batch["image"]
        imgs = imgs.float() / 255.0 if imgs.dtype == torch.uint8 else imgs.float()
        b = imgs.shape[0]
        src = imgs.permute(0, 3, 1, 2)
        rgb = (lambda v: v.expand(-1, 3, -1, -1)) if src.shape[1] == 1 else (lambda v: v)
        y = rgb(random_spatial(gen, src, 2, global_size, (0.3, 1.0)))
        gt = normalize_imagenet(y)
        x = random_corrupt(gen, y, with_cutout=True)
        loc = rgb(random_spatial(gen, src, n_local, local_size, (0.05, 0.3)))
        loc = random_corrupt(gen, loc, with_cutout=False)

        def nhwc(v, views):
            return v.reshape(b, views, *v.shape[1:]).permute(0, 1, 3, 4, 2).contiguous()

        x, gt = nhwc(x, 2), nhwc(gt, 2)
        return {"x1": x[:, 0].contiguous(), "x2": x[:, 1].contiguous(),
                "gt": gt[:, 0].contiguous(), "gt2": gt[:, 1].contiguous(),
                "locals": nhwc(loc, n_local)}

    return aug_fn
