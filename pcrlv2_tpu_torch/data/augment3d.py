"""3D augmentation on the device (port of the live stack of
``pcrlv2_tpu/data/augment3d.py``; reference torchio stack ``data.py:73-89``).

Every function works on a batch of single-channel volumes (N, X, Y, Z), each
sample with its own parameters.  The deterministic pieces take their
parameters as arguments (``flip``, ``affine_shear``, ``blur``, ``gamma``,
``swap_patches``, ``z_normalize``), so tests hold them to the JAX package on
the same parameters; the ``random_*`` functions draw those parameters from an
explicit ``torch.Generator`` with the torchio default ranges:

* flip of axis 0 with p = 0.5;
* affine: per-axis scale U(0.9, 1.1), Euler rotation U(−10°, 10°) about the
  centre, linear resampling, minimum-value padding;
* blur: per-axis Gaussian σ ~ U(0, 2), reflect padding, 17 taps;
* noise: additive N(0, σ²), σ ~ U(0, 0.25);
* gamma: γ = exp(U(−0.3, 0.3)), sign-preserving power;
* swap: 100 transpositions of patches on the (8, 4, 4) grid (globals only);
* z-normalization with the unbiased σ.

The affine resamples by 7 banded passes (``affine_shear``, the default) or
by one trilinear gather (``affine_exact``, the golden path), chosen by
``PCRL_AFFINE`` (``affine_impl``).  The Model-Genesis ops, dormant in the
reference (``lunaDataset.py:128-220``), follow the same split: Bézier
intensity map (``bezier_map``), local pixel shuffling (``shuffle_blocks``),
in- and out-painting (``in_painting``, ``out_painting`` over ``box_mask``);
``make_luna_aug_fn``'s flags turn on the last three, as the JAX CLI's do.
All of it is written for CUDA graphs: parameters are drawn on the device,
index tables come from ``arange`` on the device, every launch is made
whatever the draws (painting is selected per sample with ``torch.where``),
and nothing is read back to the host.
"""

from __future__ import annotations

import math
import os

import torch

from pcrlv2_tpu_torch.ops.blur import blur_axis, gaussian_kernel

# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------


def flip(img: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Flip axis 0 of the samples where ``do`` (N,) is true."""
    return torch.where(do[:, None, None, None], img.flip(1), img)


def rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """(N, 3) Euler angles in radians → (N, 3, 3) R = Rx·Ry·Rz."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat([[one, zero, zero], [zero, c[:, 0], -s[:, 0]], [zero, s[:, 0], c[:, 0]]])
    ry = mat([[c[:, 1], zero, s[:, 1]], [zero, one, zero], [-s[:, 1], zero, c[:, 1]]])
    rz = mat([[c[:, 2], -s[:, 2], zero], [s[:, 2], c[:, 2], zero], [zero, zero, one]])
    return rx @ ry @ rz


#: einsum of one resampling pass (k = resampled axis, j = shear source axis)
_PASS_EQ = {
    (0, 1): "byin,bnyz->biyz",
    (0, 2): "bzin,bnyz->biyz",
    (1, 0): "bxin,bxnz->bxiz",
    (1, 2): "bzin,bxnz->bxiz",
    (2, 0): "bxin,bxyn->bxyi",
    (2, 1): "byin,bxyn->bxyi",
}


def _elem_pass(v, k, j, s, lam, tau):
    """Re-read axis ``k`` at ``s·x_k + λ·x_j + τ`` with linear interpolation,
    as a banded (N_out × N_in) matrix per x_j line; rows out of range get
    zero weights (constant-0 padding)."""
    n, nj = v.shape[k + 1], v.shape[j + 1]
    i = torch.arange(n, dtype=torch.float32, device=v.device)
    jc = torch.arange(nj, dtype=torch.float32, device=v.device)
    src = (s[:, None, None] * i[None, None, :]
           + lam[:, None, None] * jc[None, :, None] + tau[:, None, None])
    w = torch.clamp(1.0 - torch.abs(src[..., None] - i), min=0.0)
    return torch.einsum(_PASS_EQ[(k, j)], w, v)


def affine_shear(img: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
    """Affine warp ``p ↦ Minv·(p−c)+c`` of each sample as 7 elementary
    resampling passes (Minv LU-factored; each pass fixes the centre), with
    minimum-value padding."""
    c = [(n - 1.0) / 2.0 for n in img.shape[1:]]
    m = minv
    l10 = m[:, 1, 0] / m[:, 0, 0]
    l20 = m[:, 2, 0] / m[:, 0, 0]
    u11 = m[:, 1, 1] - l10 * m[:, 0, 1]
    u12 = m[:, 1, 2] - l10 * m[:, 0, 2]
    l21 = (m[:, 2, 1] - l20 * m[:, 0, 1]) / u11
    u22 = m[:, 2, 2] - l20 * m[:, 0, 2] - l21 * u12
    u00, u01, u02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]

    mn = img.float().amin(dim=(1, 2, 3), keepdim=True)
    v = img.float() - mn
    one = torch.ones_like(u00)
    zero = torch.zeros_like(u00)

    def cpass(vol, k, j, s, lam):
        return _elem_pass(vol, k, j, s, lam, c[k] * (1.0 - s) - lam * c[j])

    v = cpass(v, 1, 0, one, l10)
    v = cpass(v, 2, 0, one, l20)
    v = cpass(v, 2, 1, one, l21)
    v = cpass(v, 2, 0, u22, zero)
    v = cpass(v, 1, 2, u11, u12)
    v = cpass(v, 0, 1, u00, u01)
    v = cpass(v, 0, 2, one, u02 / u00)
    return (v + mn).to(img.dtype)


def affine_exact(img: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
    """Affine warp ``p ↦ Minv·(p−c)+c`` of each sample (``minv`` (N, 3, 3),
    c = (shape − 1)/2) by one trilinear gather, with minimum-value padding:
    the port of ``_affine_exact`` (``jax.scipy.ndimage.map_coordinates``,
    order 1, constant 0 outside, after the sample's minimum is subtracted
    and before it is added back).  Each output voxel sums its 8 corners,
    each weighted by the product of its per-axis weights and counted as 0
    where any of its indices falls outside the volume."""
    shape = img.shape[1:]
    n, dev = img.shape[0], img.device
    axes = [torch.arange(s, dtype=torch.float32, device=dev) - (s - 1) / 2.0 for s in shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(3, -1)
    src = minv.float() @ grid  # (N, 3, V): source coordinates about the centre
    lower, weights, valid = [], [], []
    for d, size in enumerate(shape):
        c = src[:, d] + (size - 1) / 2.0
        lo = torch.floor(c)
        hi_w = c - lo
        idx = lo.long()
        lower.append(idx)
        weights.append((1 - hi_w, hi_w))
        valid.append(((idx >= 0) & (idx < size), (idx + 1 >= 0) & (idx + 1 < size)))
    mn = img.float().amin(dim=(1, 2, 3), keepdim=True)
    vol = (img.float() - mn).reshape(n, -1)
    strides = (shape[1] * shape[2], shape[2], 1)
    out = None
    for corner in ((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)):
        lin = sum((lower[d] + corner[d]).clamp(0, shape[d] - 1) * strides[d] for d in range(3))
        ok = valid[0][corner[0]] & valid[1][corner[1]] & valid[2][corner[2]]
        w = weights[0][corner[0]] * weights[1][corner[1]] * weights[2][corner[2]]
        term = w * torch.where(ok, vol.gather(1, lin), 0.0)
        out = term if out is None else out + term
    return (out.reshape(img.shape) + mn).to(img.dtype)


#: values of ``PCRL_AFFINE``: the resampler ``random_spatial`` uses
AFFINE_IMPLS = ("shear", "exact")


def affine_impl() -> str:
    """``PCRL_AFFINE``: ``shear`` (default, ``affine_shear``) or ``exact``
    (``affine_exact``, the golden path); any other value raises."""
    impl = os.environ.get("PCRL_AFFINE", "shear").lower()
    if impl not in AFFINE_IMPLS:
        raise ValueError(f"PCRL_AFFINE={impl!r}: expected one of {AFFINE_IMPLS}")
    return impl


def random_spatial(gen: torch.Generator, img: torch.Tensor, degrees: float = 10.0,
                   scales=(0.9, 1.1), impl: str | None = None) -> torch.Tensor:
    """RandomFlip + RandomAffine (reference ``data.py:73-76``), resampled by
    ``impl`` (default ``affine_impl()``)."""
    n, dev = img.shape[0], img.device
    img = flip(img, torch.rand(n, generator=gen, device=dev) < 0.5)
    angles = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * degrees
    scale = scales[0] + (scales[1] - scales[0]) * torch.rand(
        n, 3, generator=gen, device=dev)
    # M = R·diag(scale), so M⁻¹ = diag(1/scale)·Rᵀ: no solver (on the card
    # ``torch.linalg.inv`` reads its error flags back to the host)
    rot = rotation_matrix(angles * (math.pi / 180.0))
    warp = affine_exact if (impl or affine_impl()) == "exact" else affine_shear
    return warp(img, rot.transpose(1, 2) / scale[:, :, None])


# ---------------------------------------------------------------------------
# intensity
# ---------------------------------------------------------------------------


def blur(img: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur with per-sample, per-axis σ (N, 3)."""
    out = img.float()
    for ax in range(3):
        out = blur_axis(out, gaussian_kernel(sigmas[:, ax]), ax)
    return out


def gamma(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Sign-preserving power ``sign(x)·|x|^γ`` with per-sample γ (N,)."""
    return torch.sign(img) * torch.pow(torch.abs(img), g[:, None, None, None])


def compose_swaps(pairs: torch.Tensor, n: int) -> torch.Tensor:
    """Compose transpositions ``pairs`` (N, iters, 2) of ``n`` patches, in
    draw order, into one permutation per sample (N, n): what swapping entries
    ``a`` and ``b`` of ``arange(n)`` for each pair in turn leaves.

    Swapping entries of ``perm`` is ``perm ← perm ∘ τ``, so the result is
    ``τ_1 ∘ τ_2 ∘ … ∘ τ_iters``.  Composition is associative: each τ becomes an
    index array and adjacent pairs are composed with one gather per round,
    ⌈log2 iters⌉ rounds, all on the device (no host sync)."""
    n_s, iters = pairs.shape[:2]
    rounds = max(iters - 1, 0).bit_length()
    taus = torch.arange(n, device=pairs.device).expand(n_s, 1 << rounds, n).clone()
    a, b = pairs[..., :1].long(), pairs[..., 1:].long()
    head = taus[:, :iters]
    head.scatter_(2, a, b)
    head.scatter_(2, b, a)
    while taus.shape[1] > 1:  # (A ∘ B)[i] = A[B[i]]
        taus = torch.gather(taus[:, 0::2], 2, taus[:, 1::2])
    return taus[:, 0]


def swap_patches(img: torch.Tensor, perm: torch.Tensor,
                 patch_size=(8, 4, 4)) -> torch.Tensor:
    """Patch r of the output grid is patch ``perm[r]`` of the input grid."""
    px, py, pz = patch_size
    n_s, sx, sy, sz = img.shape
    gx, gy, gz = sx // px, sy // py, sz // pz
    patches = img[:, :gx * px, :gy * py, :gz * pz].reshape(
        n_s, gx, px, gy, py, gz, pz).permute(0, 1, 3, 5, 2, 4, 6).reshape(
        n_s, gx * gy * gz, -1)
    shuffled = torch.gather(patches, 1, perm[:, :, None].expand_as(patches))
    out = shuffled.reshape(n_s, gx, gy, gz, px, py, pz).permute(
        0, 1, 4, 2, 5, 3, 6).reshape(n_s, gx * px, gy * py, gz * pz)
    if (gx * px, gy * py, gz * pz) != (sx, sy, sz):
        full = img.clone()
        full[:, :gx * px, :gy * py, :gz * pz] = out
        out = full
    return out


def z_normalize(img: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(x − μ)/σ per sample, unbiased σ."""
    x = img.float()
    n = x[0].numel()
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).sum(dim=(1, 2, 3), keepdim=True) / max(n - 1, 1)
    return (x - mean) / torch.clamp(torch.sqrt(var), min=eps)


def random_intensity(gen: torch.Generator, img: torch.Tensor,
                     swap: bool) -> torch.Tensor:
    """Blur → Noise → Gamma → [Swap] → ZNorm (reference ``data.py:77-89``)."""
    n, dev = img.shape[0], img.device
    img = blur(img, 2.0 * torch.rand(n, 3, generator=gen, device=dev))
    sigma = 0.25 * torch.rand(n, generator=gen, device=dev)
    img = img + sigma[:, None, None, None] * torch.randn(
        img.shape, generator=gen, device=dev)
    img = gamma(img, torch.exp((torch.rand(n, generator=gen, device=dev) * 2 - 1)
                               * 0.3))
    if swap:
        grid = img.shape[1] // 8 * (img.shape[2] // 4) * (img.shape[3] // 4)
        pairs = torch.randint(0, grid, (n, 100, 2), generator=gen, device=dev)
        img = swap_patches(img, compose_swaps(pairs, grid))
    return z_normalize(img)


# ---------------------------------------------------------------------------
# Model-Genesis ops (reference lunaDataset.py:128-220, dormant upstream)
# ---------------------------------------------------------------------------


def _bcast(t: torch.Tensor) -> torch.Tensor:
    """(N,) → (N, 1, 1, 1)."""
    return t[:, None, None, None]


def bezier_map(img: torch.Tensor, rnd: torch.Tensor, flip_only_x: torch.Tensor,
               apply: torch.Tensor, n_points: int = 100000) -> torch.Tensor:
    """Bézier intensity remap per sample (port of ``bezier_intensity_map``,
    reference ``lunaDataset.py:128-141``): control points (0, 0),
    (rnd₀, rnd₁), (rnd₂, rnd₃), (1, 1) (``rnd`` (N, 4)), the curve sampled at
    ``n_points`` in the reference's Bernstein order (t³ first); its x-values
    sorted, its y-values too unless ``flip_only_x`` (N,); each voxel mapped
    through it by linear interpolation (``jnp.interp``: the right-sided
    search, ends clamped, a zero-width segment takes its left value); the
    sample kept as it was unless ``apply`` (N,)."""
    n, dev = img.shape[0], img.device
    t = torch.linspace(0.0, 1.0, n_points, device=dev)
    basis = torch.stack([t ** 3, 3.0 * t ** 2 * (1 - t), 3.0 * t * (1 - t) ** 2, (1 - t) ** 3])
    zero, one = torch.zeros_like(rnd[:, 0]), torch.ones_like(rnd[:, 0])
    xp = (torch.stack([zero, rnd[:, 0], rnd[:, 2], one], 1) @ basis).sort(1).values
    yv = torch.stack([zero, rnd[:, 1], rnd[:, 3], one], 1) @ basis
    fp = torch.where(flip_only_x[:, None], yv, yv.sort(1).values)
    x = img.reshape(n, -1).float()
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n_points - 1)
    x0, x1 = xp.gather(1, i - 1), xp.gather(1, i)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    dx = x1 - x0
    flat = dx.abs() <= float(torch.finfo(torch.float32).eps) * 2.0 ** -23
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    f = torch.where(x > xp[:, -1:], fp[:, -1:], f)
    return torch.where(_bcast(apply), f.reshape(img.shape), img)


def random_bezier(gen: torch.Generator, img: torch.Tensor,
                  n_points: int = 100000) -> torch.Tensor:
    """``bezier_map`` with rnd ~ U(0, 1)⁴, ``flip_only_x`` and ``apply``
    each with p = 0.5."""
    n, dev = img.shape[0], img.device
    rnd = torch.rand(n, 4, generator=gen, device=dev)
    flip_only_x = torch.rand(n, generator=gen, device=dev) < 0.5
    apply = torch.rand(n, generator=gen, device=dev) < 0.5
    return bezier_map(img, rnd, flip_only_x, apply, n_points)


def shuffle_block_size(shape, max_block_frac: int = 10):
    """Edge of the blocks ``random_pixel_shuffle`` shuffles: shape //
    ``max_block_frac`` per axis, at least 1 ((6, 6, 3) at 64×64×32)."""
    return tuple(max(s // max_block_frac, 1) for s in shape)


def shuffle_blocks(img: torch.Tensor, corners: torch.Tensor, perms: torch.Tensor,
                   block) -> torch.Tensor:
    """Local pixel shuffling (port of ``local_pixel_shuffling``, reference
    ``lunaDataset.py:143-170``) on given draws: for k in order, the block of
    edge ``block`` at ``corners[:, k]`` (N, K, 3) is read and written back
    permuted, voxel j of the new block being voxel ``perms[:, k, j]`` (N, K,
    prod(block)) of the old, both flat in C order.  Blocks overlap, so a
    later block reads an earlier one's output, as in the reference."""
    n, sx, sy, sz = img.shape
    bx, by, bz = block
    dev = img.device
    offsets = (torch.arange(bx, device=dev)[:, None, None] * (sy * sz)
               + torch.arange(by, device=dev)[None, :, None] * sz
               + torch.arange(bz, device=dev)[None, None, :]).reshape(-1)
    flat = img.reshape(n, -1).clone()
    base = corners[..., 0] * (sy * sz) + corners[..., 1] * sz + corners[..., 2]
    for k in range(corners.shape[1]):
        lin = base[:, k, None] + offsets
        flat.scatter_(1, lin, flat.gather(1, lin).gather(1, perms[:, k]))
    return flat.reshape(img.shape)


def random_pixel_shuffle(gen: torch.Generator, img: torch.Tensor, num_block: int = 64,
                         max_block_frac: int = 10) -> torch.Tensor:
    """``shuffle_blocks`` of ``num_block`` blocks per sample at uniform
    corners, each permuted by the ``argsort`` of uniform keys."""
    n, dev = img.shape[0], img.device
    block = shuffle_block_size(img.shape[1:], max_block_frac)
    corners = torch.stack([torch.randint(0, s - b + 1, (n, num_block), generator=gen, device=dev)
                           for s, b in zip(img.shape[1:], block)], -1)
    keys = torch.rand(n, num_block, math.prod(block), generator=gen, device=dev)
    return shuffle_blocks(img, corners, keys.argsort(-1), block)


def box_mask(shape, corner: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """(N, *shape) bool: the box [corner, corner + size) of each sample
    (``corner``, ``size`` (N, 3) int64), as ``_random_box`` builds it."""
    m = [(torch.arange(s, device=corner.device) >= corner[:, d, None])
         & (torch.arange(s, device=corner.device) < (corner + size)[:, d, None])
         for d, s in enumerate(shape)]
    return m[0][:, :, None, None] & m[1][:, None, :, None] & m[2][:, None, None, :]


def random_box(gen: torch.Generator, n: int, shape, lo_frac: float, hi_frac: float,
               margin: int = 3, device=None):
    """``_random_box``'s draws for ``n`` samples: per axis a size uniform in
    [⌊s·lo⌋, ⌊s·hi⌋], then a corner uniform in [margin, max(s − size −
    margin, margin + 1)).  Returns (corner, size), each (N, 3) int64."""
    corners, sizes = [], []
    for s in shape:
        lo, hi = int(s * lo_frac), int(s * hi_frac)
        size = torch.randint(min(lo, hi), max(lo, hi) + 1, (n,), generator=gen, device=device)
        span = torch.clamp(s - size - margin, min=margin + 1) - margin
        u = torch.rand(n, generator=gen, device=device)
        corners.append(margin + torch.minimum((u * span).long(), span - 1))
        sizes.append(size)
    return torch.stack(corners, 1), torch.stack(sizes, 1)


def in_painting(img: torch.Tensor, corners: torch.Tensor, sizes: torch.Tensor,
                keep: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Model-Genesis in-painting (port of ``image_in_painting``, reference
    ``lunaDataset.py:172-188``) on given draws: for i in order, box i
    (``corners``, ``sizes`` (N, cnt, 3)) is overwritten with ``noise[:, i]``
    (N, cnt, *shape) unless ``keep[:, i]`` (N, cnt)."""
    for i in range(corners.shape[1]):
        box = box_mask(img.shape[1:], corners[:, i], sizes[:, i])
        img = torch.where(box & ~_bcast(keep[:, i]), noise[:, i], img)
    return img


def out_painting(img: torch.Tensor, corners: torch.Tensor, sizes: torch.Tensor,
                 skip: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Model-Genesis out-painting (port of ``image_out_painting``, reference
    ``lunaDataset.py:190-220``) on given draws: everything outside the kept
    boxes becomes ``noise`` (N, *shape); box 0 of ``corners``, ``sizes`` (N,
    1 + cnt, 3) is kept, box i ≥ 1 too unless ``skip[:, i − 1]`` (N, cnt)."""
    keep = box_mask(img.shape[1:], corners[:, 0], sizes[:, 0])
    for i in range(1, corners.shape[1]):
        box = box_mask(img.shape[1:], corners[:, i], sizes[:, i])
        keep = keep | (box & ~_bcast(skip[:, i - 1]))
    return torch.where(keep, img, noise)


def _random_boxes(gen, img, count, lo_frac, hi_frac):
    boxes = [random_box(gen, img.shape[0], img.shape[1:], lo_frac, hi_frac, device=img.device)
             for _ in range(count)]
    return torch.stack([c for c, _ in boxes], 1), torch.stack([s for _, s in boxes], 1)


def random_in_painting(gen: torch.Generator, img: torch.Tensor, cnt: int = 5) -> torch.Tensor:
    """``in_painting`` of ``cnt`` boxes of s/6…s/3 per axis, each kept with
    p = 0.05 (the reference's ``while random() < 0.95``), a full volume of
    U(0, 1) noise per box."""
    n, dev = img.shape[0], img.device
    corners, sizes = _random_boxes(gen, img, cnt, 1 / 6, 1 / 3)
    keep = torch.rand(n, cnt, generator=gen, device=dev) < 0.05
    noise = torch.rand((n, cnt) + tuple(img.shape[1:]), generator=gen, device=dev)
    return in_painting(img, corners, sizes, keep, noise)


def random_out_painting(gen: torch.Generator, img: torch.Tensor, cnt: int = 4) -> torch.Tensor:
    """``out_painting`` with 1 + ``cnt`` boxes of 3s/7…4s/7 per axis, each
    after the first skipped with p = 0.05, and a volume of U(0, 1) noise."""
    n, dev = img.shape[0], img.device
    corners, sizes = _random_boxes(gen, img, 1 + cnt, 3 / 7, 4 / 7)
    skip = torch.rand(n, cnt, generator=gen, device=dev) < 0.05
    noise = torch.rand(img.shape, generator=gen, device=dev)
    return out_painting(img, corners, sizes, skip, noise)


# ---------------------------------------------------------------------------
# batch-level aug fn for the train step
# ---------------------------------------------------------------------------


def paint_flags(gen: torch.Generator, b: int, paint_rate: float, inpaint_rate: float):
    """Per sample of a batch of ``b``: paint (p = ``paint_rate``) and, if so,
    in-paint (p = ``inpaint_rate``) rather than out-paint; each flag
    repeated for the sample's two views (rows 2i, 2i + 1).  Returns two
    (2b,) bool tensors."""
    u = torch.rand(2, b, generator=gen, device=gen.device)
    return tuple(f[:, None].expand(b, 2).reshape(-1)
                 for f in (u[0] < paint_rate, u[1] < inpaint_rate))


def make_luna_aug_fn(use_painting: bool = False, paint_rate: float = 0.5,
                     use_pixel_shuffle: bool = False, inpaint_rate: float = 0.2):
    """Batch augmentation of the 3D pipeline (reference
    ``lunaDataset.py:28-81``).

    Input ``{'pair': (B, 2, X, Y, Z), 'locals': (B, V, x, y, z)}`` raw crops
    on the target device; output views ``x1, x2, gt, gt2`` (B, X, Y, Z, 1) and
    ``locals`` (B, V, x, y, z, 1).  ``gt`` is the spatially augmented,
    uncorrupted x1 crop.  ``use_pixel_shuffle`` shuffles x1's and x2's
    pixels after their intensity transform; then ``use_painting`` paints a
    sample's both views with p = ``paint_rate``: in-painting with p =
    ``inpaint_rate``, else out-painting (both computed, one selected per
    sample, so the launches do not depend on the draws).
    """

    def aug_fn(gen: torch.Generator, batch):
        pair = batch["pair"].float()
        crops = batch["locals"].float()
        b, v = crops.shape[:2]
        gt = random_spatial(gen, pair.reshape(b * 2, *pair.shape[2:]))
        x = random_intensity(gen, gt, swap=True)
        if use_pixel_shuffle:
            x = random_pixel_shuffle(gen, x)
        if use_painting:
            do, inp = paint_flags(gen, b, paint_rate, inpaint_rate)
            painted = torch.where(_bcast(inp), random_in_painting(gen, x),
                                  random_out_painting(gen, x))
            x = torch.where(_bcast(do), painted, x)
        loc = random_spatial(gen, crops.reshape(b * v, *crops.shape[2:]))
        loc = random_intensity(gen, loc, swap=False)
        gt = gt.reshape(b, 2, *gt.shape[1:])
        x = x.reshape(b, 2, *x.shape[1:])
        return {"x1": x[:, 0, ..., None], "x2": x[:, 1, ..., None],
                "gt": gt[:, 0, ..., None], "gt2": gt[:, 1, ..., None],
                "locals": loc.reshape(b, v, *loc.shape[1:])[..., None]}

    return aug_fn
