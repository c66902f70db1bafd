"""The port's native batch reader (``pcrlv2_tpu_torch/native.py``, its own
copy of ``pcrl_io.cpp``), ``LunaBatchReader``, the batched ``HostLoader``
and the structured phantom tree, held against the JAX package's."""

import os
import subprocess

import numpy as np
import pytest

from pcrlv2_tpu import native as jax_native
from pcrlv2_tpu.data import pipeline as jax_pipeline

from pcrlv2_tpu_torch import native
from pcrlv2_tpu_torch.data import pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.fail(f"the port's native library did not load: {native.build_error()}")
    return native.get_lib()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's structured phantom tree, 10 subsets × 1 UID × 1 pair
    at 32×32×16 crops with 3 local views of 8³."""
    root = str(tmp_path_factory.mktemp("structured"))
    jax_pipeline.write_structured_luna_tree(root, n_subsets=10, uids_per_subset=1,
                                            pairs_per_uid=1, seed=2, size=(32, 32, 16),
                                            local=(8, 8, 8), n_views=3)
    return root


def _globals(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
                  if "_global_" in f)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
def test_read_npy_and_read_batch_match_jax(lib, tmp_path, dtype):
    rng = np.random.RandomState(0)
    arrays = [(rng.rand(3, 4, 5) * 1000 - 500).astype(dtype) for _ in range(4)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"a{i}.npy"))
        np.save(paths[-1], a)
    got = native.read_npy(paths[0], count=60)
    np.testing.assert_array_equal(got, jax_native.read_npy(paths[0], count=60))
    np.testing.assert_array_equal(got, arrays[0].astype(np.float32).reshape(-1))
    out, ref = np.empty((4, 3, 4, 5), np.float32), np.empty((4, 3, 4, 5), np.float32)
    native.read_batch(paths, out, n_threads=3)
    jax_native.read_batch(paths, ref, n_threads=3)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.stack(arrays).astype(np.float32))


def test_read_batch_names_the_file_of_the_wrong_size(lib, tmp_path):
    paths = [str(tmp_path / f"b{i}.npy") for i in range(3)]
    for i, p in enumerate(paths):
        np.save(p, np.zeros((2, 3) if i != 1 else (2, 4), np.float32))
    want = f"pcrl_read_batch failed on {paths[1]}"
    for reader in (native, jax_native):
        with pytest.raises(IOError, match=want):
            reader.read_batch(paths, np.empty((3, 2, 3), np.float32), n_threads=2)
    with pytest.raises(ValueError, match="float32"):
        native.read_batch(paths, np.empty((3, 2, 3), np.float64))


def test_library_is_built_in_the_ports_build_dir(lib, monkeypatch, tmp_path):
    """The library lies under ``pcrlv2_tpu_torch/_build/``; a fresh build
    compiles the port's own source there and writes nothing under
    ``native/`` (the JAX package's)."""
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR == native.SOURCE.parent.parent / "_build"
    assert native.library_path().exists()
    calls = []
    real_run = subprocess.run

    def recorded(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native.subprocess, "run", recorded)
    path = native.build()
    assert path.parent == tmp_path / "_build" and path.exists()
    assert native.build() == path and len(calls) == 1
    native_dir = os.path.join(ROOT, "native")
    assert not any(str(arg).startswith(native_dir) for arg in calls[0])
    assert str(native.SOURCE) in calls[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_luna_batch_reader_matches_jax(lib, tree, dtype):
    paths = _globals(tree)[:4]
    shapes = dict(pair_shape=(2, 32, 32, 16), local_shape=(3, 8, 8, 8), n_threads=2,
                  dtype=dtype)
    reader = pipeline.LunaBatchReader(4, **shapes)
    got = reader(paths)
    again = reader(paths[:3])
    want = jax_pipeline.LunaBatchReader(4, **shapes)(paths)
    assert reader.batches == 2
    for k in ("pair", "locals"):
        assert got[k].dtype == dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(again[k], want[k][:3])
    sample = pipeline.load_luna_sample(paths[0], dtype)
    np.testing.assert_array_equal(got["pair"][0], sample["pair"])


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batched_host_loader_is_the_jax_loader(lib, tree, shuffle, drop_last):
    """``HostLoader(batch_read_fn=...)`` gives JAX's batches in JAX's order,
    a ragged tail included when it is kept, and the per-sample loader's."""
    paths = _globals(tree)
    shapes = dict(pair_shape=(2, 32, 32, 16), local_shape=(3, 8, 8, 8), n_threads=2)
    kw = dict(shuffle=shuffle, seed=4, num_workers=2, drop_last=drop_last)
    port = pipeline.HostLoader(paths, 3, pipeline.load_luna_sample,
                               batch_read_fn=pipeline.LunaBatchReader(3, **shapes), **kw)
    ref = jax_pipeline.HostLoader(paths, 3, jax_pipeline.load_luna_sample,
                                  batch_read_fn=jax_pipeline.LunaBatchReader(3, **shapes), **kw)
    per_sample = pipeline.HostLoader(paths, 3, pipeline.load_luna_sample, **kw)
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        plain = list(per_sample.epoch(epoch))
        assert len(got) == len(want) == len(plain) == (3 if drop_last else 4)
        for a, b, c in zip(got, want, plain):
            for k in ("pair", "locals"):
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], c[k])
    assert port.batch_read_fn.batches == 2 * len(port)


def test_structured_tree_is_the_jax_tree(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(n_subsets=2, uids_per_subset=1, pairs_per_uid=2, seed=5)
    assert pipeline.write_structured_luna_tree(port, **kw) == \
        jax_pipeline.write_structured_luna_tree(ref, **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), port)
                   for d, _, fs in os.walk(port) for f in fs)
    assert len(files) == 12 and sum("_mask_" in f for f in files) == 4
    for f in files:
        assert open(os.path.join(port, f), "rb").read() == \
            open(os.path.join(ref, f), "rb").read(), f
