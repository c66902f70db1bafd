"""The port's 3D augmentation: deterministic pieces held against the JAX
package on the same parameters; random draws held to their distributions
(``torch.Generator`` cannot reproduce ``jax.random``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.data import augment3d as jaug
from pcrlv2_tpu.ops import blur as jblur

from pcrlv2_tpu_torch.data import augment3d as aug
from pcrlv2_tpu_torch.data.pipeline import synthetic_luna_batch
from pcrlv2_tpu_torch.ops import blur


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth(seed, shape):
    """A smooth random volume (the shear passes are exact on smooth data)."""
    rng = np.random.RandomState(seed)
    grid = np.meshgrid(*[np.linspace(0, 1, s) for s in shape], indexing="ij")
    return sum(np.sin(2 * np.pi * (rng.rand() * g + rng.rand())) for g in grid
               ).astype(np.float32)


def test_affine_shear_matches_jax():
    angles = np.array([[0.1, -0.15, 0.05], [-0.05, 0.12, -0.17]], np.float32)
    scales = np.array([[0.95, 1.05, 1.0], [1.08, 0.92, 1.03]], np.float32)
    imgs = np.stack([_smooth(0, (16, 12, 8)), _smooth(1, (16, 12, 8))])
    rot = aug.rotation_matrix(torch.from_numpy(angles))
    minv = torch.linalg.inv(rot * torch.from_numpy(scales)[:, None, :])
    got = aug.affine_shear(torch.from_numpy(imgs), minv)
    for i in range(2):
        jrot = jaug._rotation_matrix(jnp.asarray(angles[i]))
        np.testing.assert_allclose(rot[i].numpy(), np.asarray(jrot), rtol=1e-6, atol=1e-6)
        want = jaug._affine_shear(jnp.asarray(imgs[i]), jnp.asarray(minv[i].numpy()))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [16, 8, 12])
def test_blur_matches_jax(n):
    """17-tap Gaussian per axis, reflect padding; n=8 reflects past the far
    edge."""
    sig = np.array([0.0, 0.7, 1.9], np.float32)
    img = np.random.RandomState(2).rand(3, n, 6, 5).astype(np.float32)
    k = blur.gaussian_kernel(torch.from_numpy(sig))
    got = blur.blur_axis(torch.from_numpy(img), k, 0)
    for i in range(3):
        jk = jblur.gaussian_kernel(jnp.float32(sig[i]))
        np.testing.assert_allclose(k[i].numpy(), np.asarray(jk), rtol=1e-6, atol=1e-7)
        want = jblur.blur_axis(jnp.asarray(img[i]), jk, 0, "reflect")
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_swap_matches_jax_given_the_same_draws():
    """JAX composes 100 transpositions drawn in a fori_loop; the same pairs
    composed by the port give the same volume."""
    img = np.random.RandomState(3).rand(16, 8, 8).astype(np.float32)
    key = jax.random.key(11)
    n = (16 // 8) * (8 // 4) * (8 // 4)
    pairs, k = [], key
    for _ in range(100):
        k, sub = jax.random.split(k)
        pairs.append(np.asarray(jax.random.randint(sub, (2,), 0, n)))
    perm = aug.compose_swaps(torch.from_numpy(np.asarray(pairs))[None], n)
    got = aug.swap_patches(torch.from_numpy(img)[None], perm)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(jaug.random_swap(key, jnp.asarray(img))))


@pytest.mark.parametrize("iters", [1, 7, 100])
def test_compose_swaps_matches_swapping_in_turn(iters):
    """The gather-tree composition equals swapping entries of arange(n) for
    each pair in draw order (JAX ``random_swap``'s loop body), per sample,
    with a == b draws included."""
    n = 12
    pairs = np.random.RandomState(iters).randint(0, n, (5, iters, 2))
    pairs[0, 0] = (3, 3)
    want = np.tile(np.arange(n), (5, 1))
    for s in range(5):
        for a, b in pairs[s]:
            want[s, a], want[s, b] = want[s, b], want[s, a]
    got = aug.compose_swaps(torch.from_numpy(pairs), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flip_gamma_znorm_match_jax():
    img = np.random.RandomState(4).randn(2, 6, 4, 4).astype(np.float32)
    g = np.array([0.8, 1.3], np.float32)
    got = aug.gamma(torch.from_numpy(img), torch.from_numpy(g))
    for i in range(2):
        want = jnp.sign(img[i]) * jnp.power(jnp.abs(img[i]), g[i])
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(aug.z_normalize(torch.from_numpy(img))[i].numpy(),
                                   np.asarray(jaug.z_normalize(jnp.asarray(img[i]))),
                                   rtol=1e-5, atol=1e-6)
    flipped = aug.flip(torch.from_numpy(img), torch.tensor([True, False]))
    np.testing.assert_array_equal(flipped[0].numpy(), img[0, ::-1])
    np.testing.assert_array_equal(flipped[1].numpy(), img[1])


def test_random_draws_follow_their_distributions():
    gen = torch.Generator().manual_seed(0)
    # flip of axis 0 with p = 0.5: a ramp along axis 0 shows which were flipped
    ramp = torch.arange(8.0)[None, :, None, None].expand(400, 8, 4, 4).contiguous()
    flipped = aug.random_spatial(gen, ramp, degrees=0.0, scales=(1.0, 1.0))
    share = float((flipped[:, 0, 1, 1] > flipped[:, -1, 1, 1]).float().mean())
    assert 0.4 < share < 0.6
    # the affine keeps values inside [min, max] of the crop (linear
    # resampling, minimum-value padding)
    vol = torch.rand(6, 16, 12, 8, generator=gen)
    warped = aug.random_spatial(gen, vol)
    assert float(warped.min()) >= float(vol.min()) - 1e-6
    assert float(warped.max()) <= float(vol.max()) + 1e-6


def test_aug_fn_views():
    """Shapes of the reference views; the corrupted views are z-normalized
    per sample (mean 0, unbiased std 1); gt is the uncorrupted warp."""
    raw = synthetic_luna_batch(2, size=(16, 16, 8), local=(8, 8, 8), n_views=3, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    views = aug.make_luna_aug_fn()(torch.Generator().manual_seed(1), batch)
    assert views["x1"].shape == views["gt"].shape == views["gt2"].shape == (2, 16, 16, 8, 1)
    assert views["locals"].shape == (2, 3, 8, 8, 8, 1)
    for name in ("x1", "x2"):
        v = views[name].reshape(2, -1)
        torch.testing.assert_close(v.mean(1), torch.zeros(2), atol=1e-5, rtol=0)
        torch.testing.assert_close(v.std(1), torch.ones(2), atol=1e-5, rtol=0)
    loc = views["locals"].reshape(6, -1)
    torch.testing.assert_close(loc.std(1), torch.ones(6), atol=1e-5, rtol=0)
    assert float(views["gt"].min()) >= 0.0 and float(views["gt"].max()) <= 1.0
    assert all(torch.isfinite(v).all() for v in views.values())
