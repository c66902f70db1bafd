"""The port's offline preprocessing (``pcrlv2_tpu_torch/preprocess``, the
native resampler of ``csrc/pcrl_resample.cpp`` and the
``pcrlv2_tpu_torch.cli.luna_preprocess`` CLI) against the JAX package's, bit
for bit on the same synthetic MHD volumes and seeds: each resample path
(native, NumPy) against the same path of the JAX package, and native against
NumPy within the JAX package's own tolerance (``tests/test_native_io.py``)."""

import contextlib
import io
import os
import pathlib
import random
import zlib

import numpy as np
import pytest

import luna_preprocess as jax_cli
from pcrlv2_tpu import native as jax_native
from pcrlv2_tpu.preprocess import luna as jax_luna
from pcrlv2_tpu.preprocess import mhd as jax_mhd

from pcrlv2_tpu_torch import native
from pcrlv2_tpu_torch.cli import luna_preprocess as cli
from pcrlv2_tpu_torch.preprocess import luna, mhd


def _write_mhd(tmp_path, arr_zyx, spacing_xyz, name="vol", compressed=False):
    """A MetaImage header and its raw (or zlib ``.zraw``) blob (a copy of
    ``tests/test_preprocess.py``'s)."""
    raw_name = f"{name}.zraw" if compressed else f"{name}.raw"
    blob = arr_zyx.tobytes()
    if compressed:
        blob = zlib.compress(blob)
    with open(os.path.join(tmp_path, raw_name), "wb") as f:
        f.write(blob)
    dims = " ".join(str(s) for s in arr_zyx.shape[::-1])
    sp = " ".join(str(s) for s in spacing_xyz)
    header = (
        "ObjectType = Image\nNDims = 3\nBinaryData = True\n"
        "BinaryDataByteOrderMSB = False\n"
        f"CompressedData = {compressed}\n"
        "TransformMatrix = 1 0 0 0 1 0 0 0 1\n"
        "Offset = -195 -195 -378\n"
        f"ElementSpacing = {sp}\nDimSize = {dims}\n"
        "ElementType = MET_SHORT\n"
        f"ElementDataFile = {raw_name}\n"
    )
    path = os.path.join(tmp_path, f"{name}.mhd")
    with open(path, "w") as f:
        f.write(header)
    return path


def _lung_volume(shape=(240, 240, 120), seed=5):
    """A volume dense enough in sub-threshold voxels to pass the air filter
    (a copy of ``tests/test_preprocess.py``'s)."""
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def libs():
    for name, lib in (("port's", native), ("JAX package's", jax_native)):
        if not lib.available():
            pytest.fail(f"the {name} native library did not load")


@contextlib.contextmanager
def numpy_resample(monkeypatch):
    """Both packages' ``load_volume_1mm`` on their NumPy path."""
    with monkeypatch.context() as m:
        m.setattr(native, "resample_to_xyz", lambda *a, **k: None)
        m.setattr(jax_native, "resample_to_xyz", lambda *a, **k: None)
        yield


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "zraw"])
def test_read_mhd_matches_jax(tmp_path, compressed):
    arr = np.random.RandomState(0).randint(-1000, 1000, size=(10, 12, 14), dtype=np.int16)
    path = _write_mhd(str(tmp_path), arr, (0.7, 0.7, 2.5), compressed=compressed)
    got, want = mhd.read_mhd(path), jax_mhd.read_mhd(path)
    assert got.array.dtype == want.array.dtype == np.int16
    np.testing.assert_array_equal(got.array, want.array)
    np.testing.assert_array_equal(got.array, arr)
    assert (got.spacing, got.origin, got.header, got.size) == (
        want.spacing, want.origin, want.header, want.size)


def test_resample_plan_matches_jax():
    for shape, spacing in (((10, 10, 10), [0.703125, 0.703125, 1.25]),
                           ((133, 512, 512), [0.703125, 0.703125, 2.5]),
                           ((20, 24, 28), [0.7, 0.8, 1.3])):
        arr = np.zeros(shape, np.int16)
        for out_spacing in ((1.0, 1.0, 1.0), (0.5, 2.0, 1.5)):
            assert mhd._resample_plan(mhd.MetaImage(arr, spacing), out_spacing) == \
                jax_mhd._resample_plan(jax_mhd.MetaImage(arr, spacing), out_spacing)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_resample_paths_match_jax(libs, dtype):
    """Native against native and NumPy against NumPy, bit for bit; native
    against NumPy to fp rounding (the JAX package's 2e-3)."""
    vol = (np.random.RandomState(3).rand(20, 24, 28) * 2000 - 1000).astype(dtype)
    spacing = [0.7, 0.8, 1.3]
    out_size, scales = mhd._resample_plan(mhd.MetaImage(vol, spacing), (1.0, 1.0, 1.0))
    got = native.resample_to_xyz(vol, scales, out_size)
    np.testing.assert_array_equal(got, jax_native.resample_to_xyz(vol, scales, out_size))
    plain = mhd.resample_isotropic(mhd.MetaImage(vol, spacing)).array
    np.testing.assert_array_equal(
        plain, jax_mhd.resample_isotropic(jax_mhd.MetaImage(vol, spacing)).array)
    assert got.shape == plain.shape[::-1] == (20, 19, 26)
    np.testing.assert_allclose(got, plain.transpose(2, 1, 0), atol=2e-3)
    assert native.resample_to_xyz(vol.astype(np.float64), scales, out_size) is None


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_load_volume_1mm_matches_jax(libs, tmp_path, monkeypatch, path):
    vol = (np.random.RandomState(4).rand(12, 16, 18) * 2000 - 1000).astype(np.int16)
    mhd_path = _write_mhd(str(tmp_path), vol, (0.9, 1.1, 1.4))
    with numpy_resample(monkeypatch) if path == "numpy" else contextlib.nullcontext():
        got, want = mhd.load_volume_1mm(mhd_path), jax_mhd.load_volume_1mm(mhd_path)
    assert got.shape == (16, 18, 17) and got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_crop_arithmetic_matches_jax():
    """``normalize_hu``, ``cal_iou``, ``resize3d`` (up, down with the
    anti-alias prefilter, and without it) and ``thickness_maps``."""
    rng = np.random.RandomState(6)
    hu = rng.rand(7, 9, 11) * 4000 - 2000
    np.testing.assert_array_equal(luna.normalize_hu(hu), jax_luna.normalize_hu(hu))
    boxes = [(0, 10, 0, 10, 0, 10), (5, 15, 0, 10, 0, 10), (3, 67, 2, 66, 9, 41),
             (10, 20, 0, 10, 0, 10)]
    for a in boxes:
        for b in boxes:
            assert luna.cal_iou(a, b) == jax_luna.cal_iou(a, b)
    arr = rng.rand(26, 19, 35).astype(np.float32)
    for shape, anti_alias in (((16, 16, 16), True), ((40, 12, 35), True),
                              ((16, 16, 16), False)):
        np.testing.assert_array_equal(luna.resize3d(arr, shape, anti_alias),
                                      jax_luna.resize3d(arr, shape, anti_alias))
    cfg = luna.PreprocessConfig()
    window = rng.rand(12, 13, 35).astype(np.float32)
    for got, want in zip(luna.thickness_maps(window, cfg.hu_thred, 32, cfg.len_depth),
                         jax_luna.thickness_maps(window, cfg.hu_thred, 32, cfg.len_depth)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,seed", [((240, 240, 120), 0), ((240, 240, 60), 1)],
                         ids=["volume", "thin"])
def test_crop_pair_matches_jax(shape, seed):
    """Two pairs drawn in a row from the same ``random.Random`` and
    ``RandomState`` (the thin volume through the z padding), and both
    generators left in the same state."""
    vol = _lung_volume(shape, seed=5 + seed)
    draws = []
    for mod in (luna, jax_luna):
        rng, np_rng = random.Random(seed), np.random.RandomState(seed)
        cfg = mod.PreprocessConfig()
        pairs = [mod.crop_pair(vol, cfg, rng, np_rng) for _ in range(2)]
        draws.append((pairs, rng.random(), np_rng.rand()))
    (got, *got_state), (want, *want_state) = draws
    assert got_state == want_state
    for g, w in zip(got, want):
        assert g[0].shape == (64, 64, 32) and g[2].shape == (6, 16, 16, 16)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _mhd_tree(root):
    """Raw LUNA layout: int16 volumes of two UIDs in subset0 and one in the
    held-out subset7, anisotropic spacings that resample to about 240 × 240
    × 110 mm."""
    rng = np.random.RandomState(7)
    for subset, uids in ((0, ("1.3.6.1.4.1.9", "1.3.6.1.4.1.10")), (7, ("1.3.6.1.4.1.77",))):
        d = os.path.join(root, f"subset{subset}")
        os.makedirs(d)
        for i, uid in enumerate(uids):
            arr = (rng.rand(55 + i, 300, 300) * 600 - 1000).astype(np.int16)
            _write_mhd(d, arr, (0.8, 0.8, 2.0), name=uid)


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): pathlib.Path(d, f).read_bytes()
            for d, _, fs in os.walk(root) for f in fs}


@pytest.fixture(scope="module")
def mhd_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mhd"))
    _mhd_tree(root)
    return root


@pytest.mark.parametrize("path,n_procs", [("native", 1), ("native", 2), ("numpy", 1)])
def test_process_subsets_writes_the_jax_tree(libs, mhd_tree, tmp_path, monkeypatch,
                                             path, n_procs):
    """A whole tree (every subset swept, the absent ones skipped), byte for
    byte the JAX package's, file for file.  The JAX package's runs in this
    process (its pool forks, which a process running JAX's threads should
    not); the subsets are seeded each alone, so its tree is the same at any
    ``n_procs``."""
    trees = {}
    with numpy_resample(monkeypatch) if path == "numpy" else contextlib.nullcontext():
        for name, mod, procs in (("port", luna, n_procs), ("jax", jax_luna, 1)):
            cfg = mod.PreprocessConfig(scale=2, data_dir=mhd_tree,
                                       save_dir=str(tmp_path / name))
            assert mod.process_subsets(cfg, range(10), n_procs=procs) == 6
            trees[name] = _files(str(tmp_path / name))
    assert sorted(trees["port"]) == sorted(trees["jax"])
    assert len(trees["port"]) == 12
    assert trees["port"] == trees["jax"]


def _flags(main):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return sorted({w.strip("[],") for w in out.getvalue().split() if w.startswith("--")})


def test_cli_takes_every_flag_and_writes_the_jax_tree(libs, mhd_tree, tmp_path, capsys):
    """``python -m pcrlv2_tpu_torch.cli.luna_preprocess`` has the root
    ``luna_preprocess.py``'s flags, and with every one of them given writes
    that CLI's tree; it names the resampler it runs."""
    assert _flags(cli.main) == _flags(jax_cli.main) == [
        "--crop_cols", "--crop_rows", "--data", "--fold", "--help", "--input_cols",
        "--input_deps", "--input_rows", "--procs", "--save", "--scale"]
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        main(["--fold", "7", "--input_rows", "64", "--input_cols", "64", "--input_deps", "32",
              "--crop_rows", "64", "--crop_cols", "64", "--data", mhd_tree,
              "--save", str(tmp_path / name), "--scale", "1", "--procs", "1"])
    log = capsys.readouterr().out
    assert f"==> resampler: native ({native.library_path().name})" in log
    assert log.count("wrote 1 crop pairs") == 2
    want = _files(str(tmp_path / "jax"))
    assert sorted(want) == ["subset7/1.3.6.1.4.1.77_global_0.npy",
                            "subset7/1.3.6.1.4.1.77_local_0.npy"]
    assert _files(str(tmp_path / "port")) == want
