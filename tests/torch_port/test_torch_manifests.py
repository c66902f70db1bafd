"""The port's manifest generator (``pcrlv2_tpu_torch/data/make_manifests.py``)
against the JAX package's on ``tests/test_manifest_tools.py``'s trees: the
chest image scan, the chest splits and the ``main`` CLI, file for file."""

import os
import pathlib

import pytest

from pcrlv2_tpu.data import make_manifests as jax_manifests

from pcrlv2_tpu_torch.data import make_manifests


def _chest_tree(root):
    """Ten PNGs, a JPEG one level down and a text file to skip (the tree of
    ``tests/test_manifest_tools.py::test_write_chest_manifests``)."""
    (root / "sub").mkdir(parents=True)
    for i in range(10):
        (root / f"a_{i}.png").write_bytes(b"x")
    (root / "sub" / "b.jpg").write_bytes(b"x")
    (root / "notes.txt").write_text("skip me")


def _raw_luna_tree(root):
    """Two subsets of three ``.mhd`` UIDs (the tree of
    ``tests/test_manifest_tools.py::test_luna_uids_from_raw_tree``)."""
    for s in range(2):
        d = root / f"subset{s}"
        d.mkdir(parents=True)
        for u in range(3):
            (d / f"1.3.{s}.{u}.mhd").write_text("x")
            (d / f"1.3.{s}.{u}.raw").write_text("x")


def _read(out):
    return {f: pathlib.Path(out, f).read_text() for f in sorted(os.listdir(out))}


@pytest.mark.parametrize("splits,seed", [((0.6, 0.2), 1), ((0.78, 0.11), 0)])
def test_write_chest_manifests_matches_jax(tmp_path, splits, seed):
    img_dir = tmp_path / "imgs"
    _chest_tree(img_dir)
    assert make_manifests.chest_images_from_dir(str(img_dir)) == \
        jax_manifests.chest_images_from_dir(str(img_dir))
    got = make_manifests.write_chest_manifests(str(img_dir), str(tmp_path / "port"),
                                               splits=splits, seed=seed)
    want = jax_manifests.write_chest_manifests(str(img_dir), str(tmp_path / "jax"),
                                               splits=splits, seed=seed)
    assert got == want and sum(map(len, got)) == 11
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")
    assert sorted(_read(tmp_path / "port")) == ["chest_test.txt", "chest_train.txt",
                                                "chest_valid.txt"]


@pytest.mark.parametrize("dataset", ["chest", "luna"])
def test_main_matches_jax(tmp_path, capsys, dataset):
    """``main`` with every flag writes the JAX CLI's files and says the same."""
    data = tmp_path / "data"
    (_chest_tree if dataset == "chest" else _raw_luna_tree)(data)
    logs = []
    for name, main in (("port", make_manifests.main), ("jax", jax_manifests.main)):
        main(["--n", dataset, "--data", str(data), "--out", str(tmp_path / name),
              "--seed", "3", "--train_frac", "0.5", "--valid_frac", "0.25"])
        logs.append(capsys.readouterr().out.replace(str(tmp_path / name), "<out>"))
    assert logs[0] == logs[1]
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")
    with pytest.raises(SystemExit):
        make_manifests.write_chest_manifests(str(tmp_path / "port"), str(tmp_path / "o"))
