"""The port's exact affine and Model-Genesis ops held against the JAX
package given the same draws (reproduced from JAX's key splits), their own
draws held to their distributions, and the flagged aug fn's host reads."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.data import augment3d as jaug

from pcrlv2_tpu_torch.data import augment3d as aug
from pcrlv2_tpu_torch.data.pipeline import synthetic_luna_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (16, 12, 8)


def _imgs(seed, n, shape=SHAPE):
    return np.random.RandomState(seed).rand(n, *shape).astype(np.float32)


def test_affine_exact_matches_map_coordinates():
    """10° rotations and scales 0.9 / 1.1 about the centre move the corners'
    sources out of the volume, where the constant fill applies; the same
    Minv on both sides."""
    imgs = _imgs(0, 3)
    deg = np.array([[10, -10, 5], [-7, 9, -10], [0, 0, 10]], np.float32)
    scales = np.array([[0.9, 1.1, 1.0], [1.1, 0.9, 1.05], [0.9, 0.9, 0.9]], np.float32)
    rot = aug.rotation_matrix(torch.from_numpy(deg * np.float32(np.pi / 180)))
    minv = rot.transpose(1, 2) / torch.from_numpy(scales)[:, :, None]
    got = aug.affine_exact(torch.from_numpy(imgs) - 0.3, minv)
    for i in range(3):
        want = jaug._affine_exact(jnp.asarray(imgs[i] - 0.3), jnp.asarray(minv[i].numpy()))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=1e-5)
    corner = (minv[0] @ -(torch.tensor(SHAPE, dtype=torch.float32) - 1) / 2
              + (torch.tensor(SHAPE, dtype=torch.float32) - 1) / 2)
    assert (corner < 0).any() or (corner > torch.tensor(SHAPE) - 1).any()


def test_affine_impl_selects_the_resampler(monkeypatch):
    vol = torch.from_numpy(_imgs(1, 2))
    draws = {}
    for impl in ("shear", "exact"):
        monkeypatch.setenv("PCRL_AFFINE", impl.upper())
        assert aug.affine_impl() == impl
        draws[impl] = aug.random_spatial(torch.Generator().manual_seed(0), vol)
    want = aug.random_spatial(torch.Generator().manual_seed(0), vol, impl="exact")
    torch.testing.assert_close(draws["exact"], want, rtol=0, atol=0)
    assert not torch.equal(draws["shear"], draws["exact"])
    monkeypatch.setenv("PCRL_AFFINE", "gather")
    with pytest.raises(ValueError, match="PCRL_AFFINE"):
        aug.affine_impl()


@pytest.mark.parametrize("seed", [5, 8])
def test_bezier_matches_jax(seed):
    """The draws of ``bezier_intensity_map``'s key splits, fed to
    ``bezier_map``: the map applied (or not) as JAX applies it, and always
    applied under both sortings, against the JAX curve through
    ``jnp.interp`` (values outside [0, 1] clamp to the ends)."""
    img = _imgs(seed, 1)[0] * 1.2 - 0.1
    key = jax.random.key(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    rnd = np.array(jax.random.uniform(k1, (4,)))
    flip, apply = bool(jax.random.bernoulli(k2, 0.5)), bool(jax.random.bernoulli(k3, 0.5))
    t_img, t_rnd = torch.from_numpy(img)[None], torch.from_numpy(rnd)[None]
    got = aug.bezier_map(t_img, t_rnd, torch.tensor([flip]), torch.tensor([apply]))
    want = jaug.bezier_intensity_map(key, jnp.asarray(img))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-5)
    t = jnp.linspace(0.0, 1.0, 100000)
    basis = jnp.stack([t ** 3, 3.0 * t ** 2 * (1 - t), 3.0 * t * (1 - t) ** 2, (1 - t) ** 3])
    xp = jnp.sort(jnp.array([0.0, rnd[0], rnd[2], 1.0]) @ basis)
    yv = jnp.array([0.0, rnd[1], rnd[3], 1.0]) @ basis
    for only_x in (True, False):
        got = aug.bezier_map(t_img, t_rnd, torch.tensor([only_x]), torch.tensor([True]))
        want = jnp.interp(jnp.asarray(img), xp, yv if only_x else jnp.sort(yv))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_local_pixel_shuffling_matches_jax():
    """JAX's 64 blocks, their corners and permutations drawn from its key
    splits, applied in draw order by ``shuffle_blocks``: exactly JAX's
    volume (blocks of (2, 1, 1) at 20×12×8 overlap often)."""
    img = _imgs(2, 1, (20, 12, 8))[0]
    block = aug.shuffle_block_size(img.shape)
    assert block == (2, 1, 1)
    corners, perms = [], []
    for seed in (7, 9):
        k = jax.random.key(seed)
        c, p = [], []
        for _ in range(64):
            k, kc, kp = jax.random.split(k, 3)
            c.append(np.asarray(jax.random.randint(kc, (3,), jnp.array([0, 0, 0]), jnp.array(
                [s - b + 1 for s, b in zip(img.shape, block)]))))
            p.append(np.asarray(jax.random.permutation(kp, int(np.prod(block)))))
        corners.append(c)
        perms.append(p)
    got = aug.shuffle_blocks(torch.from_numpy(np.stack([img, img])),
                             torch.from_numpy(np.asarray(corners)).long(),
                             torch.from_numpy(np.asarray(perms)).long(), block)
    for i, seed in enumerate((7, 9)):
        want = jaug.local_pixel_shuffling(jax.random.key(seed), jnp.asarray(img))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert not np.array_equal(got[0].numpy(), img)


def _jax_box(key, shape, lo_frac, hi_frac, margin=3):
    """``_random_box``'s corner and size from ``key``, and its mask."""
    ks, kc = jax.random.split(key)
    shape_arr = jnp.asarray(shape)
    lo = (shape_arr * jnp.asarray(lo_frac)).astype(jnp.int32)
    hi = (shape_arr * jnp.asarray(hi_frac)).astype(jnp.int32)
    size = jax.random.randint(ks, (3,), jnp.minimum(lo, hi), jnp.maximum(lo, hi) + 1)
    corner = jax.random.randint(kc, (3,), margin,
                                jnp.maximum(shape_arr - size - margin, margin + 1))
    return (np.array(corner), np.array(size),
            np.asarray(jaug._random_box(key, shape, lo_frac, hi_frac, margin)))


def test_in_painting_matches_jax():
    """JAX's 5 iterations (box, full-volume noise, 5 % keep) from its key
    splits, fed to ``in_painting``; ``box_mask`` is JAX's box exactly."""
    imgs = _imgs(3, 2)
    seeds = (0, 1)  # key 1 keeps one of its boxes
    draws = []
    for seed in seeds:
        k, c, s, keep, noise = jax.random.key(seed), [], [], [], []
        for _ in range(5):
            k, kb, kn, kp = jax.random.split(k, 4)
            corner, size, mask = _jax_box(kb, SHAPE, 1 / 6, 1 / 3)
            got = aug.box_mask(SHAPE, torch.from_numpy(corner)[None].long(),
                               torch.from_numpy(size)[None].long())
            np.testing.assert_array_equal(got[0].numpy(), mask)
            c.append(corner)
            s.append(size)
            noise.append(np.asarray(jax.random.uniform(kn, SHAPE)))
            keep.append(bool(jax.random.bernoulli(kp, 0.05)))
        draws.append((c, s, keep, noise))
    corners, sizes, keep, noise = (torch.from_numpy(np.asarray(x)) for x in zip(*draws))
    assert keep.any() and not keep.all()
    got = aug.in_painting(torch.from_numpy(imgs), corners.long(), sizes.long(), keep, noise)
    for i, seed in enumerate(seeds):
        want = jaug.image_in_painting(jax.random.key(seed), jnp.asarray(imgs[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_out_painting_matches_jax():
    """JAX's kept box, its 4 more boxes with their 5 % skips and the noise
    volume, from its key splits, fed to ``out_painting``."""
    imgs = _imgs(4, 2)
    seeds = (6, 7)  # key 7 skips one of its boxes
    draws = []
    for seed in seeds:
        key, kn, k0 = jax.random.split(jax.random.key(seed), 3)
        corner, size, _ = _jax_box(k0, SHAPE, 3 / 7, 4 / 7)
        c, s, skip = [corner], [size], []
        for _ in range(4):
            key, kb, kp = jax.random.split(key, 3)
            corner, size, _ = _jax_box(kb, SHAPE, 3 / 7, 4 / 7)
            c.append(corner)
            s.append(size)
            skip.append(bool(jax.random.bernoulli(kp, 0.05)))
        draws.append((c, s, skip, np.asarray(jax.random.uniform(kn, SHAPE))))
    corners, sizes, skip, noise = (torch.from_numpy(np.asarray(x)) for x in zip(*draws))
    assert skip.any() and not skip.all()
    got = aug.out_painting(torch.from_numpy(imgs), corners.long(), sizes.long(), skip, noise)
    for i, seed in enumerate(seeds):
        want = jaug.image_out_painting(jax.random.key(seed), jnp.asarray(imgs[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_new_draws_follow_their_distributions():
    gen = torch.Generator().manual_seed(0)
    do, inp = aug.paint_flags(gen, 4000, 0.7, 0.2)
    assert torch.equal(do[0::2], do[1::2]) and torch.equal(inp[0::2], inp[1::2])
    assert 0.67 < float(do.float().mean()) < 0.73
    assert 0.17 < float(inp.float().mean()) < 0.23
    # boxes: sizes in [⌊s/6⌋, ⌊s/3⌋], corners in [3, max(s − size − 3, 4))
    corner, size = aug.random_box(gen, 4000, (64, 64, 32), 1 / 6, 1 / 3)
    for d, s in enumerate((64, 64, 32)):
        assert set(size[:, d].tolist()) == set(range(int(s / 6), int(s / 3) + 1))
        high = torch.clamp(s - size[:, d] - 3, min=4)
        assert bool((corner[:, d] >= 3).all() and (corner[:, d] < high).all())
        assert int(corner[:, d].max()) == s - int(s / 6) - 4
    # pixel shuffling only moves voxels within a sample
    vol = torch.rand(3, 20, 20, 10, generator=gen)
    shuffled = aug.random_pixel_shuffle(gen, vol)
    assert not torch.equal(shuffled, vol)
    torch.testing.assert_close(shuffled.reshape(3, -1).sort(1).values,
                               vol.reshape(3, -1).sort(1).values, rtol=0, atol=0)
    # Bézier: applied with p = 0.5, in [0, 1] on [0, 1] inputs
    out = aug.random_bezier(gen, torch.rand(400, 4, 4, 2, generator=gen), n_points=1000)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_flagged_aug_fn_draws_after_the_views_and_reads_nothing_back(monkeypatch):
    """With painting at rate 0 the views equal the unflagged aug fn's (the
    painting draws come after them); with every flag on and the exact
    affine the aug fn calls no host read (``item``, ``__float__``, …)."""
    raw = {k: torch.from_numpy(v) for k, v in synthetic_luna_batch(
        2, size=(16, 16, 8), local=(8, 8, 8), n_views=2, seed=1).items()}
    plain = aug.make_luna_aug_fn()(torch.Generator().manual_seed(3), raw)
    unpainted = aug.make_luna_aug_fn(use_painting=True, paint_rate=0.0)(
        torch.Generator().manual_seed(3), raw)
    for k in ("x1", "x2", "gt", "gt2"):
        torch.testing.assert_close(unpainted[k], plain[k], rtol=0, atol=0)

    def host_read(*_):
        raise AssertionError("the aug fn read a tensor back to the host")

    flagged = aug.make_luna_aug_fn(use_painting=True, paint_rate=1.0, use_pixel_shuffle=True)
    monkeypatch.setenv("PCRL_AFFINE", "exact")
    with monkeypatch.context() as mp:
        for name in ("item", "__float__", "__int__", "__bool__", "tolist"):
            mp.setattr(torch.Tensor, name, host_read)
        views = flagged(torch.Generator().manual_seed(3), raw)
    assert views["x1"].shape == plain["x1"].shape
    assert all(bool(torch.isfinite(v).all()) for v in views.values())
    assert not torch.equal(views["x1"], plain["x1"])
