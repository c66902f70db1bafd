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

The dormant Model-Genesis ops (Bézier, pixel shuffle, painting) are not
ported yet.
"""

from __future__ import annotations

import math

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


def random_spatial(gen: torch.Generator, img: torch.Tensor, degrees: float = 10.0,
                   scales=(0.9, 1.1)) -> torch.Tensor:
    """RandomFlip + RandomAffine (reference ``data.py:73-76``)."""
    n, dev = img.shape[0], img.device
    img = flip(img, torch.rand(n, generator=gen, device=dev) < 0.5)
    angles = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * degrees
    scale = scales[0] + (scales[1] - scales[0]) * torch.rand(
        n, 3, generator=gen, device=dev)
    # M = R·diag(scale), so M⁻¹ = diag(1/scale)·Rᵀ: no solver (on the card
    # ``torch.linalg.inv`` reads its error flags back to the host)
    rot = rotation_matrix(angles * (math.pi / 180.0))
    return affine_shear(img, rot.transpose(1, 2) / scale[:, :, None])


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
# batch-level aug fn for the train step
# ---------------------------------------------------------------------------


def make_luna_aug_fn():
    """Batch augmentation of the 3D pipeline (reference
    ``lunaDataset.py:28-81``).

    Input ``{'pair': (B, 2, X, Y, Z), 'locals': (B, V, x, y, z)}`` raw crops
    on the target device; output views ``x1, x2, gt, gt2`` (B, X, Y, Z, 1) and
    ``locals`` (B, V, x, y, z, 1).  ``gt`` is the spatially augmented,
    uncorrupted x1 crop.
    """

    def aug_fn(gen: torch.Generator, batch):
        pair = batch["pair"].float()
        crops = batch["locals"].float()
        b, v = crops.shape[:2]
        gt = random_spatial(gen, pair.reshape(b * 2, *pair.shape[2:]))
        x = random_intensity(gen, gt, swap=True)
        loc = random_spatial(gen, crops.reshape(b * v, *crops.shape[2:]))
        loc = random_intensity(gen, loc, swap=False)
        gt = gt.reshape(b, 2, *gt.shape[1:])
        x = x.reshape(b, 2, *x.shape[1:])
        return {"x1": x[:, 0, ..., None], "x2": x[:, 1, ..., None],
                "gt": gt[:, 0, ..., None], "gt2": gt[:, 1, ..., None],
                "locals": loc.reshape(b, v, *loc.shape[1:])[..., None]}

    return aug_fn
