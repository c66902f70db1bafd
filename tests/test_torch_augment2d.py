"""The port's 2D chest pipeline without the model's JAX side: the
augmentation's deterministic pieces held against the JAX package on the same
parameters (the JAX functions' own draws, recomputed from their keys), the
chest data plane against the JAX package's, and the ``--d 2`` CLI on the CPU
(synthetic, and a PNG tree through the decode cache and ``--resume``).

``torch.Generator`` cannot reproduce ``jax.random``, so the random draws
are held to what the JAX functions draw from their keys, passed in.  The CLI
runs use the model at full width on small views (the chest augmentation's
view sizes patched to 32²); the CPU cannot train at 224² inside the test
lane's time.
"""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.data import augment2d as jaug
from pcrlv2_tpu.data import manifests as jmanifests
from pcrlv2_tpu.data import pipeline as jpipeline

from pcrlv2_tpu_torch.cli import main as cli
from pcrlv2_tpu_torch.data import augment2d as aug
from pcrlv2_tpu_torch.data import manifests, pipeline
from pcrlv2_tpu_torch.models.resnet import ResNet18Encoder
from pcrlv2_tpu_torch.models.unet2d import PCRLv2
from pcrlv2_tpu_torch.train import checkpoint as ckpt
from pcrlv2_tpu_torch.train.trainer import SCRATCH_WARNING, Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth(seed, c, h, w):
    """A smooth random image in [0, 1] (C, H, W)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    return np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (rng.rand() * yy + rng.rand() * xx
                                                     + rng.rand())) for _ in range(c)]
                    ).astype(np.float32)


def _jax_box_draws(key, img_hw, scale):
    """What ``sample_resized_crop_box`` draws from ``key`` (its split order)."""
    keys = jax.random.split(key, 3)
    area = img_hw[0] * img_hw[1]
    target = area * jax.random.uniform(keys[0], (10,), minval=scale[0], maxval=scale[1])
    log_ratio = jax.random.uniform(keys[1], (10,), minval=np.log(3 / 4), maxval=np.log(4 / 3))
    corner = jax.random.uniform(keys[2], (2, 10))
    return [torch.from_numpy(np.array(v))[None] for v in (target, log_ratio, corner)]


@pytest.mark.parametrize("img_hw,scale", [((50, 60), (0.3, 1.0)), ((120, 40), (0.05, 0.3)),
                                          ((30, 30), (1.5, 2.0))])
def test_crop_box_and_resize_match_jax(img_hw, scale):
    """``crop_box`` on the JAX draws equals ``sample_resized_crop_box`` within
    1e-6 relative (a tall canvas rejects some attempts; a scale above 1
    rejects all of them, the centre-crop fallback); ``crop_and_resize`` of
    that box to 24² equals JAX's within 1e-5."""
    img = _smooth(1, 3, *img_hw)
    box_fn = jax.jit(jaug.sample_resized_crop_box, static_argnums=(1, 2))
    resize_fn = jax.jit(jaug.crop_and_resize, static_argnums=2)
    for seed in range(4):
        key = jax.random.key(seed)
        want = [float(v) for v in box_fn(key, img_hw, scale)]
        got = aug.crop_box(*_jax_box_draws(key, img_hw, scale), img_hw)
        np.testing.assert_allclose([float(v) for v in got], want, rtol=1e-6)
        out = aug.crop_and_resize(torch.from_numpy(img)[None],
                                  tuple(v.reshape(1, 1) for v in got), 24)
        jout = resize_fn(jnp.asarray(img), tuple(jnp.float32(v) for v in want), 24)
        np.testing.assert_allclose(out[0, 0].numpy(), np.asarray(jout), rtol=0, atol=1e-5)


def test_rotations_and_flip_match_jax():
    """The three-shear rotation (linear) within 1e-5 and the exact rotation
    (nearest) exactly, at ±10° and two odd sizes, against JAX's
    ``_rotate_shear`` / ``_rotate_exact``; ``hflip`` flips W."""
    rot_shear = jax.jit(lambda im, t: jaug._rotate_shear(im, t, 10.0))
    rot_exact = jax.jit(jaug._rotate_exact)
    for c, h, w in ((3, 37, 30), (1, 24, 41)):
        img = _smooth(2, c, h, w)
        thetas = np.deg2rad(np.array([-10.0, -3.3, 0.0, 7.9, 10.0], np.float32))
        batch = torch.from_numpy(np.repeat(img[None], len(thetas), 0))
        got_shear = aug.rotate_shear(batch, torch.from_numpy(thetas))
        got_exact = aug.rotate_exact(batch, torch.from_numpy(thetas))
        for i, t in enumerate(thetas):
            np.testing.assert_allclose(got_shear[i].numpy(),
                                       np.asarray(rot_shear(jnp.asarray(img), t)),
                                       rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got_exact[i].numpy(),
                                          np.asarray(rot_exact(jnp.asarray(img), t)))
    flipped = aug.hflip(batch, torch.tensor([True, False, True, False, False]))
    assert torch.equal(flipped[0], batch[0].flip(2)) and torch.equal(flipped[1], batch[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCRL_ROTATE", "bilinear")
        with pytest.raises(ValueError, match="PCRL_ROTATE"):
            aug.rotate_impl()


def test_intensity_ops_match_jax():
    """Grayscale, the edge-padded blur (1e-6), colour jitter with JAX's
    draws from its key (1e-5; one grey image, where every pixel takes the
    HSV conversion's zero branches, and two colour ones), ImageNet
    normalization and cutout at JAX's hole centres (exact)."""
    grey = np.repeat(_smooth(3, 1, 28, 34), 3, 0)
    imgs = np.stack([grey, _smooth(4, 3, 28, 34), _smooth(5, 3, 28, 34)])
    t = torch.from_numpy(imgs)
    got = aug.grayscale(t, torch.tensor([True, False, True]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jnp.broadcast_to(
        jaug.rgb_to_gray(jnp.asarray(imgs[2]))[None], (3, 28, 34))), rtol=0, atol=1e-7)
    assert torch.equal(got[1], t[1])
    sigmas = np.array([0.1, 1.3, 2.0], np.float32)
    blurred = aug.gaussian_blur_2d(t, torch.from_numpy(sigmas))
    jitter, cut = jax.jit(jaug.color_jitter), jax.jit(jaug.cutout)
    jblur = jax.jit(jaug.gaussian_blur_2d)
    factors, centers = [], []
    for i in range(3):
        np.testing.assert_allclose(
            blurred[i].numpy(), np.asarray(jblur(jnp.asarray(imgs[i]), sigmas[i])),
            rtol=0, atol=1e-6)
        key = jax.random.key(10 + i)
        kb, kc, ks, kh = jax.random.split(key, 4)
        factors.append([float(jax.random.uniform(k, (), minval=lo, maxval=hi))
                        for k, lo, hi in ((kb, 0.6, 1.4), (kc, 0.6, 1.4), (ks, 0.6, 1.4),
                                          (kh, -0.4, 0.4))])
        holes = jax.random.split(key, 3)
        centers.append([[int(jax.random.randint(k, (), 0, 28)),
                         int(jax.random.randint(jax.random.fold_in(k, 1), (), 0, 34))]
                        for k in holes])
    f = torch.tensor(factors)
    jittered = aug.color_jitter(t, *f.unbind(1))
    normed = aug.normalize_imagenet(jittered)
    holed = aug.cutout(normed, torch.tensor(centers))
    for i in range(3):
        key = jax.random.key(10 + i)
        jj = jitter(key, jnp.asarray(imgs[i]))
        np.testing.assert_allclose(jittered[i].numpy(), np.asarray(jj), rtol=0, atol=1e-5)
        jn = jaug.normalize_imagenet(jj)
        np.testing.assert_allclose(normed[i].numpy(), np.asarray(jn), rtol=0, atol=5e-5)
        hole = np.asarray(cut(key, jn)) == 0
        np.testing.assert_array_equal(holed[i].numpy() == 0, hole | (normed[i].numpy() == 0))


def test_uint8_grey_equals_float_rgb_and_the_views():
    """A uint8 grey batch (the data plane's) and the same pixels as float RGB
    (value/255 in every channel) give the same views from the same
    generator seed (within 1e-6: a one-channel crop is computed apart and
    broadcast); the views have ``chestDataset.py:48``'s shapes, and ``gt``
    is ``x1`` before its corruption (normalized, finite)."""
    rng = np.random.RandomState(0)
    grey = rng.randint(0, 256, (2, 80, 80, 1)).astype(np.uint8)
    rgb = np.repeat(grey.astype(np.float32) / 255.0, 3, -1)
    fn = aug.make_chest_aug_fn(n_local=3, global_size=32, local_size=16)
    a = fn(torch.Generator().manual_seed(5), {"image": torch.from_numpy(grey)})
    b = fn(torch.Generator().manual_seed(5), {"image": torch.from_numpy(rgb)})
    shapes = {"x1": (2, 32, 32, 3), "x2": (2, 32, 32, 3), "gt": (2, 32, 32, 3),
              "gt2": (2, 32, 32, 3), "locals": (2, 3, 16, 16, 3)}
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    for k in shapes:
        assert a[k].dtype == torch.float32 and torch.isfinite(a[k]).all()
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    # a grey source stays grey through the corruption (saturation 0)
    assert torch.allclose(a["gt"][..., 0] * 0.229 + 0.485, a["gt"][..., 1] * 0.224 + 0.456,
                          atol=1e-5)


# ---------------------------------------------------------------------------
# the chest data plane
# ---------------------------------------------------------------------------


def _png_tree(root, sizes=((40, 40, "L"), (40, 40, "L"), (40, 40, "RGBA"), (30, 40, "L"))):
    """Chest-like PNGs and a ``chest_train.txt`` (name + 14 labels) listing
    them; returns the names."""
    from PIL import Image

    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    rng = np.random.RandomState(1)
    names = []
    for i, (h, w, mode) in enumerate(sizes):
        name = f"imgs/x{i:03d}.png"
        arr = rng.randint(0, 256, (h, w) if mode == "L" else (h, w, 4)).astype(np.uint8)
        Image.fromarray(arr, mode).save(os.path.join(root, name))
        names.append(name)
    with open(os.path.join(root, "chest_train.txt"), "w") as f:
        for name in names:
            f.write(name + " " + " ".join(str(int(v)) for v in rng.rand(14) > 0.5) + "\n")
    return names


def test_chest_data_plane_matches_jax(tmp_path):
    """``get_chest_list``, ``synthetic_chest_batch``, ``load_chest_sample``
    (grey and RGBA PNGs, resized or not) and ``CachedChestReader`` (its
    file names, a decode then a cached read) equal the JAX package's."""
    root = str(tmp_path)
    _png_tree(root)
    txt = os.path.join(root, "chest_train.txt")
    names, labels = manifests.get_chest_list(txt, root)
    assert (names, labels) == jmanifests.get_chest_list(txt, root)
    for k, v in pipeline.synthetic_chest_batch(2, canvas=16, seed=3).items():
        np.testing.assert_array_equal(v, jpipeline.synthetic_chest_batch(2, canvas=16, seed=3)[k])
    reader = pipeline.CachedChestReader(os.path.join(root, "cache"), 40)
    jreader = jpipeline.CachedChestReader(os.path.join(root, "jcache"), 40)
    for name in names:
        want = jpipeline.load_chest_sample(name, canvas=40)["image"]
        got = pipeline.load_chest_sample(name, canvas=40)["image"]
        assert got.dtype == np.uint8 and got.shape == (40, 40, 1)
        np.testing.assert_array_equal(got, want)
        assert os.path.basename(reader.cache_path(name)) == os.path.basename(
            jreader._cache_path(name))
        for _ in range(2):
            np.testing.assert_array_equal(reader(name)["image"], want)
    assert (reader.decoded, reader.cached) == (len(names), len(names))


def _small_views(monkeypatch):
    """The CLI's chest augmentation at 32² views, 2 of them local (the
    encoder's stride; the model keeps its widths)."""
    monkeypatch.setattr(cli, "make_chest_aug_fn",
                        partial(aug.make_chest_aug_fn, n_local=2, global_size=32,
                                local_size=32))


def test_cli_trains_2d_synthetic_and_loads_encoder_weights(monkeypatch, tmp_path, capsys):
    """``--synthetic --d 2 --n chest`` on the CPU, one step: it warns that
    the encoder starts from scratch, logs finite losses, and its ``.pt``
    (the encoder only) loads strictly into ``ResNet18Encoder``; a second run
    with ``--encoder_weights`` that file starts its encoder from it and does
    not warn."""
    _small_views(monkeypatch)
    out = str(tmp_path / "a")
    argv = ["--synthetic", "--d", "2", "--n", "chest", "--b", "2", "--chest_canvas", "64",
            "--epochs", "0", "--steps_per_epoch", "1", "--log_every", "1", "--seed", "1",
            "--device", "cpu"]
    trainer = cli.main(argv + ["--output", out])
    assert SCRATCH_WARNING in capsys.readouterr().out
    assert trainer.state.model.dim == 2 and int(trainer.state.step) == 1
    row = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl")) if '"iter"' in s][0]
    assert all(np.isfinite(row[k]) for k in ("loss", "mg_loss", "cos_loss", "local_loss"))
    pt = os.path.join(out, "pcrlv2_chest_pretask_1.0_0.pt")
    encoder = ResNet18Encoder(device="cpu", seed=9)
    assert ckpt.import_resnet18_encoder(pt, encoder)["epoch"] == 0
    model, cfg, loaders, aug_fn, _ = cli.prepare(
        argv + ["--output", str(tmp_path / "b"), "--encoder_weights", pt])
    assert isinstance(model, PCRLv2) and cfg.encoder_weights == pt
    trainer = Trainer(model, cfg, aug_fn, "cpu")
    trainer.load_encoder_weights(pt)
    for k, v in encoder.state_dict().items():
        assert torch.equal(model.encoder.state_dict()[k], v), k
    cli.main(argv + ["--output", str(tmp_path / "c"), "--encoder_weights", pt])
    printed = capsys.readouterr().out
    assert f"==> encoder initialized from {pt}" in printed and SCRATCH_WARNING not in printed


def test_cli_2d_disk_path_caches_evaluates_and_resumes(monkeypatch, tmp_path, capsys):
    """``--data <PNG tree> --d 2 --n chest``: the canvas is the largest
    image's side (remembered in a sidecar), the first run decodes each image
    once into ``--chest_cache auto`` and trains, evaluates (views of a fixed
    seed per batch: the same twice, the state untouched) and saves; the
    ``--resume`` run reads every image from the cache, decodes none and
    continues at epoch 1."""
    _small_views(monkeypatch)
    root, out = str(tmp_path / "tree"), str(tmp_path / "out")
    names = _png_tree(root, sizes=((64, 64, "L"), (64, 64, "L"), (64, 64, "RGBA"),
                                   (48, 64, "L")))
    argv = ["--data", root, "--d", "2", "--n", "chest", "--b", "2", "--eval_every", "1",
            "--eval_batches", "1", "--save_every", "1", "--log_every", "1", "--seed", "0",
            "--device", "cpu", "--output", out,
            "--train_list", os.path.join(root, "luna_train.txt")]
    model, cfg, loaders, aug_fn, device = cli.prepare(argv + ["--epochs", "0"])
    assert "chest canvas 64, detected from 4 images" in capsys.readouterr().out
    reader = loaders["train"].read_fn
    assert isinstance(reader, pipeline.CachedChestReader) and reader.canvas == 64
    trainer = cli.run_training(model, cfg, loaders["train"], aug_fn, device,
                               eval_loader=loaders["eval"])
    assert (reader.decoded, int(trainer.state.step)) == (len(names), 2)
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    evals = [trainer.evaluate(loaders["eval"].epoch(0)) for _ in range(2)]
    assert evals[0] == evals[1] and all(np.isfinite(v) for v in evals[0].values())
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    rows = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["epoch"] for r in rows if "eval" in r] == [0]
    model, cfg, loaders, aug_fn, device = cli.prepare(
        argv + ["--epochs", "1", "--resume", os.path.join(out, "train_state")])
    assert "chest canvas 64 from" in capsys.readouterr().out
    reader = loaders["train"].read_fn
    trainer = cli.run_training(model, cfg, loaders["train"], aug_fn, device,
                               eval_loader=loaders["eval"])
    assert "==> resumed at epoch 1" in capsys.readouterr().out
    # the loader reads ahead of the eval batch it stops at
    assert reader.decoded == 0 and reader.cached >= len(names) + 2
    assert int(trainer.state.step) == 4
