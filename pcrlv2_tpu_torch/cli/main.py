"""Command-line entry point of the port (flag names of reference ``main.py``
and ``pcrlv2_tpu/cli/main.py``).

    PCRL_CONV3D=packed python -m pcrlv2_tpu_torch.cli.main --d 3 --n luna \
        --phase pretask --data <processed tree> [--eval_every 1] \
        [--save_every 1] [--resume <output>/train_state] [--amp] [--device cpu] \
        [--profile_dir <dir>] [--use_painting [--paint_rate 0.5]] \
        [--use_pixel_shuffle] [--mixup 0.2]
    python -m pcrlv2_tpu_torch.cli.main --synthetic --d 3 [--b 4 --epochs 0 \
        --steps_per_epoch 3]
    python -m pcrlv2_tpu_torch.cli.main --d 2 --n chest --phase pretask \
        --data <chest image dir> [--train_list <dir>/chest_train.txt] \
        [--chest_canvas 0] [--chest_cache auto|off|<dir>] \
        [--encoder_weights resnet18.pt] [--amp]
    python -m pcrlv2_tpu_torch.cli.main --synthetic --d 2 --n chest [--b 16]

Runs 3D LUNA or 2D chest X-ray pretraining on one CUDA device (``--device
cpu`` only when asked), each step after the first a CUDA graph replay
(``train/trainer.py``).
``PCRL_CONV3D`` (``pallas``, the default, ``packed`` or ``im2col``) picks the
3³ conv kernels; the graphs keep the kernels they captured.  ``PCRL_AFFINE``
(``shear``, the default, or ``exact``) picks the affine's resampler.  On
``--data`` the train batches are read by the native reader
(``native.py``) when its library builds, else by NumPy; the run says which.
The chest images are decoded once (Pillow) onto a square canvas of their
native size (``--chest_canvas 0``, detected from every image, remembered in a
sidecar of the output directory) and kept as uint8 arrays in a cache
(``--chest_cache``); the 2D encoder starts from scratch unless
``--encoder_weights`` names a torchvision ResNet-18 state_dict.
Paths not ported yet stop naming the JAX module they wait for.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import time
from functools import partial

import numpy as np

from pcrlv2_tpu_torch import native
from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
from pcrlv2_tpu_torch.data.augment2d import make_chest_aug_fn
from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
from pcrlv2_tpu_torch.data.make_manifests import write_luna_manifest
from pcrlv2_tpu_torch.data.manifests import (get_chest_list, get_luna_list,
                                             get_luna_pretrain_list)
from pcrlv2_tpu_torch.data.pipeline import (CachedChestReader, HostLoader, LunaBatchReader,
                                            load_chest_sample, load_luna_sample,
                                            synthetic_chest_batch, synthetic_luna_batch)
from pcrlv2_tpu_torch.models.unet2d import PCRLv2
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train.trainer import TrainConfig, run_training

DEFAULT_TRAIN_LIST = "train_val_txt/luna_train.txt"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PCRLv2 pretraining (PyTorch/CUDA)")
    parser.add_argument("--data", metavar="DIR", default=None,
                        help="processed LUNA tree (luna_preprocess.py output) or "
                             "chest image directory")
    parser.add_argument("--model", default="pcrlv2")
    parser.add_argument("--phase", default="pretask", help="pretask | finetune")
    parser.add_argument("--b", default=16, type=int, help="batch size")
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--output", default="./out", help="checkpoint dir")
    parser.add_argument("--n", default="luna", help="dataset name: luna | chest")
    parser.add_argument("--d", default=3, type=int, help="2d or 3d pipeline")
    parser.add_argument("--workers", default=4, type=int, help="host loader threads")
    parser.add_argument("--gpus", default="0", help="device list (one device)")
    parser.add_argument("--ratio", default=1.0, type=float,
                        help="fraction of the train UIDs used for pretraining")
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight_decay", default=1e-4, type=float)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--amp", action="store_true", default=False,
                        help="bf16 compute, f32 parameters")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--train_list", default=DEFAULT_TRAIN_LIST,
                        help="UID list, derived from --data (into --output) "
                             "when the default path is missing; for --n chest "
                             "the image list (a luna list's name stands for "
                             "chest_train.txt beside it)")
    parser.add_argument("--encoder_weights", default=None, metavar="PT",
                        help="torchvision ResNet-18 state_dict (.pt) that "
                             "initializes the 2D encoder, the ImageNet-init "
                             "analog of the reference's default")
    parser.add_argument("--chest_canvas", default=0, type=int,
                        help="square canvas chest X-rays are decoded onto; 0 = "
                             "the largest source's size, detected from every "
                             "image (1024 for NIH)")
    parser.add_argument("--chest_cache", default="auto",
                        help="decode-once uint8 cache of chest X-rays: auto = "
                             "<output>/chest_cache, off = decode every epoch, "
                             "else a directory")
    parser.add_argument("--synthetic", action="store_true", default=False,
                        help="train on synthetic data")
    parser.add_argument("--steps_per_epoch", default=None, type=int,
                        help="cap of batches per epoch (synthetic data: "
                             "batches per epoch, default 4)")
    parser.add_argument("--log_every", default=10, type=int)
    parser.add_argument("--profile_dir", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run here")
    parser.add_argument("--resume", default=None, metavar="DIR",
                        help="train-state directory to continue from "
                             "(<output>/train_state of an earlier run)")
    parser.add_argument("--eval_every", default=0, type=int,
                        help="epochs between eval-loss passes over the held-"
                             "out folds 7-9 (0 = off)")
    parser.add_argument("--eval_batches", default=0, type=int,
                        help="cap of batches per eval pass (0 = the whole fold)")
    parser.add_argument("--save_every", default=0, type=int,
                        help="also save the train state every N epochs (0 = "
                             "only at the reference epochs, %%100 == 0 or 240)")
    parser.add_argument("--h2d_dtype", default="auto", choices=("auto", "f32", "f16"),
                        help="dtype raw 3D batches are read and moved in; auto = "
                             "f16 with --amp, f32 otherwise")
    parser.add_argument("--mixup", default=None, type=float,
                        help="input-mixup alpha: x1, x2 and gt mixed with a batch "
                             "permutation at λ ~ Beta(α, α) (the reference defines "
                             "mixup_data but never calls it, train_2d.py:44)")
    parser.add_argument("--use_painting", action="store_true", default=False,
                        help="in/out-painting corruption (the Model-Genesis ops "
                             "dormant in the reference, lunaDataset.py:45-55)")
    parser.add_argument("--paint_rate", default=0.5, type=float,
                        help="probability of painting when --use_painting")
    parser.add_argument("--use_pixel_shuffle", action="store_true", default=False,
                        help="local pixel shuffling (dormant upstream, "
                             "lunaDataset.py:43-44)")
    parser.add_argument("--spatial", default=1, type=int, help="(not ported yet)")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="(not ported yet)")
    return parser


def _not_ported(what: str, module: str):
    raise SystemExit(f"{what} is not ported yet (it waits for {module})")


class SyntheticLoader:
    """``steps`` in-memory raw batches per epoch, seeded per batch as the JAX
    CLI's synthetic loader does: LUNA crops (``dim`` 3) or chest images on a
    ``canvas``² float canvas (``dim`` 2; the JAX CLI's default, the NIH
    size the real default would detect, is 1024)."""

    def __init__(self, batch_size: int, steps: int, seed: int, dim: int = 3,
                 canvas: int = 1024):
        self.batch_size, self.steps, self.seed = batch_size, steps, seed
        self.dim, self.canvas = dim, canvas

    def epoch(self, epoch: int):
        for i in range(self.steps):
            seed = self.seed + epoch * self.steps + i
            if self.dim == 2:
                yield synthetic_chest_batch(self.batch_size, canvas=self.canvas, seed=seed)
            else:
                yield synthetic_luna_batch(self.batch_size, seed=seed)


class Capped:
    """At most ``steps`` batches of each of ``inner``'s epochs (the JAX CLI's
    ``_limit`` for ``--steps_per_epoch`` on real data)."""

    def __init__(self, inner, steps: int):
        self.inner, self.steps = inner, steps

    def epoch(self, epoch: int):
        return itertools.islice(self.inner.epoch(epoch), self.steps)


def luna_pretask_loaders(args) -> dict:
    """Train and eval loaders over a processed LUNA tree (the JAX CLI's
    ``DataGenerator.pcrlv2_luna_pretask``): train = the top ``--ratio`` of
    the UID list in folds 0-6, shuffled per epoch, ragged tail dropped;
    eval = folds 7-9 in order, every sample (``None`` without any)."""
    if not os.path.exists(args.train_list):
        # the UID list is a dataset-release artifact; a processed tree
        # carries the same UIDs, so derive the list (into the run's output
        # dir when the path is the default) instead of stopping
        if args.train_list == DEFAULT_TRAIN_LIST:
            args.train_list = os.path.join(args.output, "luna_train.txt")
        if not os.path.exists(args.train_list):
            uids = write_luna_manifest(args.data, args.train_list)
            print(f"==> train list not found; derived {len(uids)} UIDs from "
                  f"{args.data} into {args.train_list}")
    uids = get_luna_pretrain_list(args.ratio, args.train_list)
    x_train, x_valid, _ = get_luna_list(
        args.data, train_fold=range(7), valid_fold=range(7, 10),
        test_fold=range(7, 10), suffix="_global_", file_list=uids)
    print(f"total train images {len(x_train)}, validation images {len(x_valid)}")
    h2d = args.h2d_dtype if args.h2d_dtype != "auto" else ("f16" if args.amp else "f32")
    if h2d == "f16":
        print("==> h2d_dtype f16: raw batches are read and moved at half width "
              "(--h2d_dtype f32 for the exact-parity path)")
    dtype = np.float16 if h2d == "f16" else np.float32
    read_fn = partial(load_luna_sample, dtype=dtype)
    train = HostLoader(x_train, args.b, read_fn, shuffle=True, seed=args.seed,
                       num_workers=args.workers,
                       batch_read_fn=native_batch_reader(args, x_train[0], dtype))
    # drop_last=False: dropping the ragged tail would leave up to b-1
    # held-out samples out of every pass
    evaluate = (HostLoader(x_valid, args.b, read_fn, shuffle=False, seed=args.seed,
                           num_workers=args.workers, drop_last=False)
                if x_valid else None)
    return {"train": train, "eval": evaluate}


def native_batch_reader(args, first_path: str, dtype):
    """The train loader's ``LunaBatchReader`` when the native library loads
    (the JAX CLI's choice), its buffers shaped as the tree's first crop pair
    and local crops (the JAX CLI assumes ``luna_preprocess.py``'s shapes);
    else None, the NumPy reader, with the build error printed."""
    if not native.available():
        print(f"==> reader: NumPy (the native library did not load: {native.build_error()})")
        return None
    pair = np.load(first_path, mmap_mode="r").shape
    local = np.load(first_path.replace("global", "local"), mmap_mode="r").shape
    print(f"==> reader: native ({native.library_path().name}, "
          f"{max(args.workers, 2)} threads)")
    return LunaBatchReader(args.b, pair, local, n_threads=max(args.workers, 2), dtype=dtype)


def detect_chest_canvas(names, output_dir: str) -> int:
    """The largest side over every image of ``names`` (the JAX CLI's
    ``_detect_chest_canvas``): each file's header is read with Pillow, and
    the result is kept in ``<output>/chest_canvas.<hash of the list>.json``
    with a fingerprint of every file's size and mtime, so a later run over
    the same, unchanged files reads one stat per file instead."""
    tag = hashlib.blake2s("\n".join(names).encode(), digest_size=8).hexdigest()
    fingerprint = hashlib.blake2s(digest_size=8)
    for name in names:
        try:
            st = os.stat(name)
            fingerprint.update(f"{st.st_size}:{st.st_mtime_ns};".encode())
        except OSError:
            fingerprint.update(b"missing;")
    fp = fingerprint.hexdigest()
    sidecar = os.path.join(output_dir, f"chest_canvas.{tag}.json")
    try:
        with open(sidecar) as f:
            cached = json.load(f)
        if cached.get("fingerprint") == fp:
            print(f"==> chest canvas {cached['canvas']} from {sidecar}")
            return int(cached["canvas"])
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        pass  # missing, torn or stale: scan
    try:
        from PIL import Image
    except ImportError as err:
        raise SystemExit("detecting the chest canvas needs Pillow (PIL), which is not "
                         "installed: pass --chest_canvas") from err
    t0 = time.time()
    sizes = set()
    for name in names:
        with Image.open(name) as im:  # the header only
            sizes.add(max(im.size))
    canvas = max(sizes)
    print(f"==> chest canvas {canvas}, detected from {len(names)} images in "
          f"{time.time() - t0:.1f} s ({len(sizes)} distinct sizes; the largest)")
    os.makedirs(output_dir, exist_ok=True)
    tmp = f"{sidecar}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"canvas": canvas, "n_sources": len(names), "fingerprint": fp,
                   "distinct_sizes": sorted(sizes)}, f)
    os.replace(tmp, sidecar)
    return canvas


def chest_reader(args, canvas: int):
    """The per-image reader ``--chest_cache`` asks for: a ``CachedChestReader``
    (``auto`` = ``<output>/chest_cache``, or the directory given), or with
    ``off`` a decode every time."""
    cache = args.chest_cache
    if cache and cache != "off":
        if cache == "auto":
            cache = os.path.join(args.output, "chest_cache")
        print(f"==> chest decode cache: {cache} (canvas {canvas}; --chest_cache off "
              f"to disable)")
        return CachedChestReader(cache, canvas)
    return partial(load_chest_sample, canvas=canvas)


def chest_pretask_loaders(args) -> dict:
    """Train and eval loaders over a chest image list (the JAX CLI's
    ``DataGenerator.pcrlv2_chest_pretask``): the top ``--ratio`` of the list,
    train shuffled per epoch (ragged tail dropped), eval the same images in
    order, every one (the reference's eval loader aliases the train
    pipeline; a fixed order keeps the metric on the same samples)."""
    txt = args.train_list
    if "luna" in os.path.basename(txt):
        txt = os.path.join(os.path.dirname(txt) or ".", "chest_train.txt")
    names, _ = get_chest_list(txt, args.data)
    names = names[: int(len(names) * args.ratio)]
    print(f"total train images {len(names)}")
    canvas = args.chest_canvas if args.chest_canvas > 0 else detect_chest_canvas(
        names, args.output)
    read = chest_reader(args, canvas)
    train = HostLoader(names, args.b, read, shuffle=True, seed=args.seed,
                       num_workers=args.workers)
    evaluate = HostLoader(names, args.b, read, shuffle=False, seed=args.seed,
                          num_workers=args.workers, drop_last=False)
    return {"train": train, "eval": evaluate}


def prepare(argv=None):
    """Parse ``argv`` and build what ``main`` trains: ``(model, cfg,
    loaders, aug_fn, device)``, ``loaders`` = ``{"train", "eval"}`` for
    ``run_training``.  ``--d 3`` trains ``PCRLv23d`` on LUNA crops, ``--d 2``
    ``PCRLv2`` on chest X-rays."""
    args = build_parser().parse_args(argv)
    if args.d not in (2, 3):
        raise SystemExit(f"unsupported --d {args.d}")
    if args.model != "pcrlv2" or args.phase not in ("pretask", "finetune"):
        raise SystemExit(f"no trainer for (model={args.model}, phase={args.phase})")
    if args.phase == "finetune":
        _not_ported("--phase finetune", "pcrlv2_tpu/train/finetune.py")
    if args.spatial > 1:
        _not_ported("--spatial", "pcrlv2_tpu/parallel/spatial_train.py")
    if args.multihost or len([g for g in str(args.gpus).split(",") if g]) > 1:
        _not_ported("training on more than one device", "pcrlv2_tpu/core/mesh.py")
    if args.encoder_weights and args.d != 2:
        raise SystemExit("--encoder_weights applies to the 2D pipeline (--d 2)")
    if not args.synthetic:
        if not args.data:
            raise SystemExit("--data is required (or pass --synthetic)")
        if args.n != {3: "luna", 2: "chest"}[args.d]:
            raise SystemExit(f"--d {args.d} --n {args.n}: the 3D pipeline reads --n luna, "
                             "the 2D one --n chest")

    device = resolve_device(args.device)
    policy = DEFAULT_POLICY if args.amp else PARITY_POLICY
    cfg = TrainConfig(model=args.model, n=args.n, phase=args.phase, b=args.b,
                      epochs=args.epochs, lr=args.lr, output=args.output,
                      ratio=args.ratio, momentum=args.momentum,
                      weight_decay=args.weight_decay, seed=args.seed,
                      amp=args.amp, log_every=args.log_every,
                      eval_every=args.eval_every, eval_batches=args.eval_batches,
                      save_every=args.save_every, resume=args.resume,
                      profile_dir=args.profile_dir, mixup=args.mixup,
                      encoder_weights=args.encoder_weights)
    if args.synthetic:
        loaders = {"train": SyntheticLoader(args.b, args.steps_per_epoch or 4, args.seed,
                                            dim=args.d, canvas=args.chest_canvas or 1024),
                   "eval": None}
    else:
        loaders = (luna_pretask_loaders if args.d == 3 else chest_pretask_loaders)(args)
        if args.steps_per_epoch is not None:
            loaders["train"] = Capped(loaders["train"], args.steps_per_epoch)
    if args.d == 2:
        if args.use_painting or args.use_pixel_shuffle:
            raise SystemExit("--use_painting and --use_pixel_shuffle are ops of the 3D "
                             "augmentation")
        model = PCRLv2(policy=policy, seed=args.seed, device=device)
        aug_fn = make_chest_aug_fn()
    else:
        model = PCRLv23d(policy=policy, seed=args.seed, device=device)
        aug_fn = make_luna_aug_fn(use_painting=args.use_painting, paint_rate=args.paint_rate,
                                  use_pixel_shuffle=args.use_pixel_shuffle)
    return model, cfg, loaders, aug_fn, device


def main(argv=None):
    """Train as ``argv`` says; returns the ``Trainer``."""
    model, cfg, loaders, aug_fn, device = prepare(argv)
    print(f"training pcrlv2 {model.dim}d on {device}")
    return run_training(model, cfg, loaders["train"], aug_fn, device,
                        eval_loader=loaders["eval"])


if __name__ == "__main__":
    main()
