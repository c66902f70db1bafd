"""The port's LUNA data plane against the JAX package's: UID lists and the
manifest written from a tree, the synthetic tree itself, ``HostLoader``
batches bit for bit, f16 reading, and the prefetch's CPU pass-through.

The tree is the JAX package's ``write_synthetic_luna_tree`` at 10 subsets
of one UID and one pair (full-size crops, 11 MB).
"""

import os

import numpy as np
import pytest
import torch

from pcrlv2_tpu.data import make_manifests as jax_make_manifests
from pcrlv2_tpu.data import manifests as jax_manifests
from pcrlv2_tpu.data import pipeline as jax_pipeline

from pcrlv2_tpu_torch.data import make_manifests, manifests, pipeline


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("luna"))
    jax_pipeline.write_synthetic_luna_tree(root, n_subsets=10, uids_per_subset=1,
                                           pairs_per_uid=1, seed=3)
    return root


def test_manifest_and_lists_match_jax(tree, tmp_path):
    path, jpath = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    uids = make_manifests.write_luna_manifest(tree, path)
    assert uids == jax_make_manifests.write_luna_manifest(tree, jpath)
    assert open(path).read() == open(jpath).read()
    assert make_manifests.luna_uids_from_tree(tree) == uids
    for ratio in (1.0, 0.5):
        kept = manifests.get_luna_pretrain_list(ratio, path)
        assert kept == jax_manifests.get_luna_pretrain_list(ratio, path)
        args = (tree, range(7), range(7, 10), range(7, 10), "_global_", kept)
        assert manifests.get_luna_list(*args) == jax_manifests.get_luna_list(*args)
    with pytest.raises(SystemExit, match="no LUNA series"):
        make_manifests.write_luna_manifest(str(tmp_path), str(tmp_path / "none.txt"))


def test_synthetic_tree_is_the_jax_tree(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(n_subsets=2, uids_per_subset=1, pairs_per_uid=2, seed=5)
    assert pipeline.write_synthetic_luna_tree(port, **kw) == \
        jax_pipeline.write_synthetic_luna_tree(ref, **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), port)
                   for d, _, fs in os.walk(port) for f in fs)
    assert len(files) == 8
    for f in files:
        assert open(os.path.join(port, f), "rb").read() == \
            open(os.path.join(ref, f), "rb").read(), f


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_host_loader_batches_are_the_jax_batches(tree, shuffle, drop_last):
    """Two epochs, batch 3 over 10 crops: the same samples in the same
    order, bit for bit, and the ragged tail only without ``drop_last``."""
    paths = manifests.get_luna_list(tree, range(10), (), ())[0]
    kw = dict(shuffle=shuffle, seed=7, num_workers=2, drop_last=drop_last)
    port = pipeline.HostLoader(paths, 3, pipeline.load_luna_sample, **kw)
    ref = jax_pipeline.HostLoader(paths, 3, jax_pipeline.load_luna_sample, **kw)
    assert len(port) == len(ref) == (3 if drop_last else 4)
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == len(port)
        for a, b in zip(got, want):
            assert a.keys() == b.keys() == {"pair", "locals"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
    if shuffle:  # epochs differ in order
        assert not np.array_equal(next(port.epoch(0))["pair"], next(port.epoch(1))["pair"])


def test_f16_reading(tree):
    """f16 halves the bytes moved; the crops are in [0, 1), where f16 rounds
    by at most 2^-11 relative (and 2^-25 absolute below 2^-14)."""
    path = manifests.get_luna_list(tree, range(1), (), ())[0][0]
    half = pipeline.load_luna_sample(path, dtype=np.float16)
    full = pipeline.load_luna_sample(path)
    ref = jax_pipeline.load_luna_sample(path, dtype=np.float16)
    for k in ("pair", "locals"):
        assert half[k].dtype == np.float16 and full[k].dtype == np.float32
        np.testing.assert_array_equal(half[k], ref[k])
        np.testing.assert_allclose(half[k].astype(np.float32), full[k],
                                   rtol=2 ** -11, atol=2 ** -25)


def test_prefetch_passes_batches_through_on_the_cpu():
    batches = [pipeline.synthetic_luna_batch(2, size=(4, 4, 4), local=(2, 2, 2),
                                             n_views=2, seed=s) for s in range(3)]
    got = list(pipeline.device_prefetch(iter(batches), "cpu"))
    assert len(got) == 3
    for a, b in zip(got, batches):
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_prefetch_raises_what_the_loader_raises():
    def failing():
        yield pipeline.synthetic_luna_batch(1, size=(2, 2, 2), local=(2, 2, 2))
        raise OSError("disk gone")

    it = pipeline.device_prefetch(failing(), "cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_host_loader_refuses_an_empty_list():
    with pytest.raises(ValueError, match="empty"):
        pipeline.HostLoader([], 2, pipeline.load_luna_sample)
