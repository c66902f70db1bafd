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
    python -m pcrlv2_tpu_torch.cli.main --d 3 --n luna --phase finetune \
        --data <processed tree> --train_list <uid list> --ratio 0.5 \
        [--weight <pretask .pt>] [--mask_dir <mask tree>] [--eval_every 1]
    python -m pcrlv2_tpu_torch.cli.main --d 2 --n chest --phase finetune \
        --data <chest image dir> [--weight <.pt>] [--n_class 14]
    python -m pcrlv2_tpu_torch.cli.main --synthetic --d 3|2 --phase finetune

Runs 3D LUNA or 2D chest X-ray pretraining, or the downstream finetuning
(3D segmentation, 2D 14-label classification; ``train/finetune.py``), on
one CUDA device (``--device cpu`` only when asked), each step after the
first a CUDA graph replay (``train/trainer.py``).
``PCRL_CONV3D`` (``pallas``, the default, ``packed`` or ``im2col``) picks the
3³ conv kernels; the graphs keep the kernels they captured.  ``PCRL_AFFINE``
(``shear``, the default, or ``exact``) picks the affine's resampler.  On
``--data`` the train batches are read by the native reader
(``native.py``) when its library builds, else by NumPy; the run says which.
The chest images are decoded once (Pillow) onto a square canvas of their
native size (``--chest_canvas 0``, detected from every image, remembered in a
sidecar of the output directory) and kept as uint8 arrays in a cache
(``--chest_cache``); the 2D encoder starts from scratch unless
``--encoder_weights`` names a torchvision ResNet-18 state_dict.  Finetuning
starts from ``--weight`` (a pretask ``.pt``; 2D: its encoder, or a bare
torchvision state_dict) and trains on the complement of the pretrain UID
split (3D; ``--ratio`` < 1) or the chest list's top ``--ratio`` at 224²
(2D), evaluating on folds 7-9 or ``chest_valid.txt`` under ``--eval_every``.
Paths not ported yet stop naming the JAX module they wait for.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import multiprocessing
import os
import socket
import sys
import time
from functools import partial
from multiprocessing.connection import wait

import numpy as np
import torch

from pcrlv2_tpu_torch import native
from pcrlv2_tpu_torch.core import mesh
from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
from pcrlv2_tpu_torch.data.augment2d import make_chest_aug_fn
from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
from pcrlv2_tpu_torch.data.make_manifests import write_luna_manifest
from pcrlv2_tpu_torch.data.manifests import (get_chest_list, get_luna_finetune_list,
                                             get_luna_list, get_luna_pretrain_list)
from pcrlv2_tpu_torch.data.pipeline import (CachedChestReader, HostLoader, LunaBatchReader,
                                            load_chest_sample, load_luna_sample,
                                            make_luna_mask_reader, synthetic_chest_batch,
                                            synthetic_luna_batch)
from pcrlv2_tpu_torch.models.unet2d import PCRLv2
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train.finetune import run_finetune
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
    parser.add_argument("--gpus", default="0",
                        help="device list, e.g. 0,1,2,3: one process per device used, "
                             "min(listed, available) of them (rank r on the r-th listed "
                             "GPU; with --device cpu, gloo processes); --b is the global "
                             "batch")
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
    parser.add_argument("--weight", default=None, metavar="PT",
                        help="pretrained .pt --phase finetune starts from (ours "
                             "or the reference's): 2D loads its encoder (fc.* "
                             "dropped, README.md:40-44), 3D the whole PCRLv23d "
                             "(README.md:50-54)")
    parser.add_argument("--mask_dir", default=None, metavar="DIR",
                        help="3D finetune: segmentation mask tree mirroring the "
                             "crop tree (subset{i}/{uid}_mask_{k}.npy; the --data "
                             "root itself when the masks lie beside the crops); "
                             "without it the target is the intensity-threshold "
                             "pseudo-mask")
    parser.add_argument("--n_class", default=14, type=int,
                        help="2D finetune: classifier labels (14 = NIH "
                             "ChestX-ray); 3D segments one channel")
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
    parser.add_argument("--spatial", default=1, type=int,
                        help="(not ported yet; --phase finetune refuses it)")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="join the process group torchrun's environment describes "
                             "(torchrun --nproc_per_node N ... --multihost), one process "
                             "per device on cuda:LOCAL_RANK; --b is the global batch, each "
                             "process loads its interleaved dataset slice and b/world "
                             "samples; a group even at world 1")
    return parser


def _not_ported(what: str, module: str):
    raise SystemExit(f"{what} is not ported yet (it waits for {module})")


def shard_for_process(args, *lists):
    """Under ``--multihost``, this rank's interleaved slice of each list and a
    copy of ``args`` with its ``b / world`` batch (the JAX CLI's
    ``_shard_for_process``; ``--b`` is the global batch).  Every rank's
    slice is trimmed to the common ``len(lst) // world``: a rank with one
    more sample would run a step the others do not, and the collectives
    would wait for it forever.  Otherwise ``args`` and the whole lists, as
    the JAX CLI leaves them on one host: ranks spawned for ``--gpus`` take
    their rows of each global batch instead (``loader_part``)."""
    rank, world = args.rank, args.world
    if world == 1 or not args.multihost:
        return args, lists
    local = argparse.Namespace(**{**vars(args), "b": args.b // world})
    return local, tuple(lst[rank::world][: len(lst) // world] for lst in lists)


def loader_part(args):
    """``HostLoader``'s ``part`` of a rank spawned for ``--gpus``: (rank,
    world), rows [r·b/w, (r+1)·b/w) of each global batch of ``--b`` drawn
    from the whole list, as the JAX CLI's one process splits its batches
    over the devices; None for one rank and under ``--multihost`` (sliced
    lists, ``shard_for_process``)."""
    if args.world == 1 or args.multihost:
        return None
    return args.rank, args.world


class SyntheticLoader:
    """``steps`` in-memory raw batches per epoch, seeded per batch as the JAX
    CLI's synthetic loader does: LUNA crops (``dim`` 3) or chest images on a
    ``canvas``² float canvas (``dim`` 2; the JAX CLI's default, the NIH
    size the real default would detect, is 1024, and 224 for finetuning),
    with ``n_class`` binary labels a chest image when ``n_class`` > 0
    (``RandomState(seed).randint(0, 2, (b, n_class))``, the finetune
    batches)."""

    def __init__(self, batch_size: int, steps: int, seed: int, dim: int = 3,
                 canvas: int = 1024, n_class: int = 0):
        self.batch_size, self.steps, self.seed = batch_size, steps, seed
        self.dim, self.canvas, self.n_class = dim, canvas, n_class

    def epoch(self, epoch: int):
        for i in range(self.steps):
            seed = self.seed + epoch * self.steps + i
            if self.dim == 2:
                batch = synthetic_chest_batch(self.batch_size, canvas=self.canvas, seed=seed)
                if self.n_class:
                    batch["label"] = np.random.RandomState(seed).randint(
                        0, 2, (self.batch_size, self.n_class)).astype(np.float32)
                yield batch
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
    args, (x_train, x_valid) = shard_for_process(args, x_train, x_valid)
    h2d = args.h2d_dtype if args.h2d_dtype != "auto" else ("f16" if args.amp else "f32")
    if h2d == "f16":
        print("==> h2d_dtype f16: raw batches are read and moved at half width "
              "(--h2d_dtype f32 for the exact-parity path)")
    dtype = np.float16 if h2d == "f16" else np.float32
    read_fn = partial(load_luna_sample, dtype=dtype)
    part = loader_part(args)
    train = HostLoader(x_train, args.b, read_fn, shuffle=True, seed=args.seed,
                       num_workers=args.workers,
                       batch_read_fn=native_batch_reader(args, x_train[0], dtype), part=part)
    # drop_last=False: dropping the ragged tail would leave up to b-1
    # held-out samples out of every pass
    evaluate = (HostLoader(x_valid, args.b, read_fn, shuffle=False, seed=args.seed,
                           num_workers=args.workers, drop_last=False, part=part)
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


def chest_list(args) -> str:
    """The chest image list: ``--train_list``, where a luna list's name
    stands for ``chest_train.txt`` beside it."""
    txt = args.train_list
    if "luna" in os.path.basename(txt):
        txt = os.path.join(os.path.dirname(txt) or ".", "chest_train.txt")
    return txt


def chest_pretask_loaders(args) -> dict:
    """Train and eval loaders over a chest image list (the JAX CLI's
    ``DataGenerator.pcrlv2_chest_pretask``): the top ``--ratio`` of the list,
    train shuffled per epoch (ragged tail dropped), eval the same images in
    order, every one (the reference's eval loader aliases the train
    pipeline; a fixed order keeps the metric on the same samples)."""
    names, _ = get_chest_list(chest_list(args), args.data)
    names = names[: int(len(names) * args.ratio)]
    print(f"total train images {len(names)}")
    canvas = args.chest_canvas if args.chest_canvas > 0 else detect_chest_canvas(
        names, args.output)
    args, (names,) = shard_for_process(args, names)
    read = chest_reader(args, canvas)
    part = loader_part(args)
    train = HostLoader(names, args.b, read, shuffle=True, seed=args.seed,
                       num_workers=args.workers, part=part)
    evaluate = HostLoader(names, args.b, read, shuffle=False, seed=args.seed,
                          num_workers=args.workers, drop_last=False, part=part)
    return {"train": train, "eval": evaluate}


def luna_finetune_loaders(args) -> dict:
    """Train and eval loaders of 3D finetuning (the JAX CLI's
    ``DataGenerator.pcrlv2_luna_finetune``): the UIDs after the top
    ``--ratio`` of the list (the complement of the pretrain split) in folds
    0-6, shuffled per epoch, ragged tail dropped; under ``--eval_every``,
    folds 7-9 in order, every sample.  With ``--mask_dir`` each sample
    carries its mask (``make_luna_mask_reader``)."""
    if not os.path.exists(args.train_list):
        raise SystemExit(f"train list not found: {args.train_list}")
    uids = get_luna_finetune_list(args.ratio, args.train_list)
    if not uids:
        raise SystemExit(f"--ratio {args.ratio} leaves no finetune UIDs (the finetune split "
                         "is the COMPLEMENT of the pretrain split; use --ratio < 1.0)")
    # the held-out folds are read only when an eval pass will use them
    eval_folds = range(7, 10) if args.eval_every > 0 else ()
    x_train, x_valid, _ = get_luna_list(args.data, train_fold=range(7), valid_fold=eval_folds,
                                        test_fold=(), suffix="_global_", file_list=uids)
    print(f"finetune train images {len(x_train)}"
          + (f", validation images {len(x_valid)}" if eval_folds else ""))
    # the JAX CLI slices the train list alone here (its eval list whole)
    args, (x_train,) = shard_for_process(args, x_train)
    if args.mask_dir:
        if not os.path.isdir(args.mask_dir):
            raise SystemExit(f"--mask_dir not found: {args.mask_dir}")
        read_fn = make_luna_mask_reader(args.data, args.mask_dir)
        print(f"==> 3D finetune against REAL masks from {args.mask_dir}")
    else:
        read_fn = load_luna_sample
        print("==> 3D finetune against intensity-threshold pseudo-masks (documented "
              "placeholder; pass --mask_dir <tree> for real segmentation GT)")
    part = loader_part(args)
    train = HostLoader(x_train, args.b, read_fn, shuffle=True, seed=args.seed,
                       num_workers=args.workers, part=part)
    evaluate = (HostLoader(x_valid, args.b, read_fn, shuffle=False, seed=args.seed,
                           num_workers=args.workers, drop_last=False, part=part)
                if x_valid else None)
    return {"train": train, "eval": evaluate}


def _labelled(read, names, labels):
    """``read`` plus each image's labels."""
    label_of = {n: np.asarray(lab, np.float32) for n, lab in zip(names, labels)}
    return lambda path: {**read(path), "label": label_of[path]}


def chest_finetune_loaders(args) -> dict:
    """Train and eval loaders of 2D finetuning (the JAX CLI's
    ``DataGenerator.pcrlv2_chest_finetune``): the top ``--ratio`` of the
    chest list with its 14 labels, decoded onto the classifier's 224²
    canvas, shuffled per epoch; under ``--eval_every``, ``chest_valid.txt``
    beside the list, in order, every image (without it, no eval pass)."""
    txt = chest_list(args)
    names, labels = get_chest_list(txt, args.data)
    keep = max(1, int(len(names) * args.ratio))
    names, labels = names[:keep], labels[:keep]
    print(f"finetune train images {len(names)} (ratio {args.ratio})")
    local, (names, labels) = shard_for_process(args, names, labels)
    read = chest_reader(args, canvas=224)
    part = loader_part(args)
    train = HostLoader(names, local.b, _labelled(read, names, labels), shuffle=True,
                       seed=args.seed, num_workers=args.workers, part=part)
    evaluate = None
    if args.eval_every > 0:
        vtxt = os.path.join(os.path.dirname(txt) or ".", "chest_valid.txt")
        if os.path.exists(vtxt):
            vnames, vlabels = get_chest_list(vtxt, args.data)
            print(f"finetune validation images {len(vnames)}")
            _, (vnames, vlabels) = shard_for_process(args, vnames, vlabels)
            evaluate = HostLoader(vnames, local.b, _labelled(read, vnames, vlabels),
                                  shuffle=False, seed=args.seed, num_workers=args.workers,
                                  drop_last=False, part=part)
        else:
            print(f"WARNING: --eval_every set but {vtxt} not found — finetune runs without "
                  "an eval pass")
    return {"train": train, "eval": evaluate}


def refuse(args) -> None:
    """Stop on what the port does not run, before any process starts."""
    if args.d not in (2, 3):
        raise SystemExit(f"unsupported --d {args.d}")
    if args.model != "pcrlv2" or args.phase not in ("pretask", "finetune"):
        raise SystemExit(f"no trainer for (model={args.model}, phase={args.phase})")
    finetune = args.phase == "finetune"
    if finetune and args.multihost:
        raise SystemExit("--phase finetune does not support --multihost (the finetune "
                         "trainer runs single-process); launch it on one host")
    if finetune and args.spatial > 1:
        raise SystemExit("--phase finetune does not support --spatial")
    if args.spatial > 1:
        _not_ported("--spatial", "pcrlv2_tpu/parallel/spatial_train.py")
    if args.encoder_weights and args.d != 2:
        raise SystemExit("--encoder_weights applies to the 2D pipeline (--d 2)")
    if args.encoder_weights and finetune:
        raise SystemExit("--encoder_weights initializes the 2D pretask encoder; --phase "
                         "finetune starts from --weight")
    if args.weight and not finetune:
        raise SystemExit("--weight applies to --phase finetune")
    if args.mask_dir and not (finetune and args.d == 3):
        raise SystemExit("--mask_dir applies to --d 3 --phase finetune")
    if not args.synthetic:
        if not args.data:
            raise SystemExit("--data is required (or pass --synthetic)")
        if args.n != {3: "luna", 2: "chest"}[args.d]:
            raise SystemExit(f"--d {args.d} --n {args.n}: the 3D pipeline reads --n luna, "
                             "the 2D one --n chest")


def configure(argv=None, device=None, group=None):
    """Parse ``argv``, refuse what the port does not run, and build what
    both phases share: ``(args, device, policy, cfg)``.  ``device`` (default:
    ``--device``'s, the first GPU ``--gpus`` lists) and ``group`` (the data-
    parallel process group; None: one rank) are the rank's; ``args`` then
    carries ``rank`` and ``world``."""
    args = build_parser().parse_args(argv)
    refuse(args)
    args.rank, args.world = mesh.rank(group), mesh.world(group)
    if mesh.batch_not_shardable(args.b, args.world):
        raise SystemExit(f"global batch {args.b} not divisible by {args.world} processes")
    if device is None:
        device = rank_device(args, 0)
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
    return args, device, policy, cfg


def prepare(argv=None, device=None, group=None):
    """Parse ``argv`` and build what ``main`` pretrains: ``(model, cfg,
    loaders, aug_fn, device)``, ``loaders`` = ``{"train", "eval"}`` for
    ``run_training``.  ``--d 3`` trains ``PCRLv23d`` on LUNA crops, ``--d 2``
    ``PCRLv2`` on chest X-rays; ``device`` and ``group`` as ``configure``
    takes them (the loaders read this rank's slice)."""
    args, device, policy, cfg = configure(argv, device, group)
    if args.phase != "pretask":
        raise SystemExit("prepare builds --phase pretask; --phase finetune is "
                         "prepare_finetune's")
    if args.synthetic:
        loaders = {"train": SyntheticLoader(args.b // args.world, args.steps_per_epoch or 4,
                                            mesh.rank_seed(args.seed, args.rank), dim=args.d,
                                            canvas=args.chest_canvas or 1024),
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


def prepare_finetune(argv=None, device=None, group=None):
    """Parse ``argv`` (``--phase finetune``) and build what ``main``
    finetunes: ``(cfg, loaders, device, options)``, for ``run_finetune(cfg,
    loaders["train"], eval_loader=loaders["eval"], device=device,
    **options)``; ``options`` = dim, n_class (1 in 3D), policy, weight.
    Synthetic data: 3D LUNA crops, or 2D images on a 224² canvas with
    ``--n_class`` labels; a second loader is the eval split under
    ``--eval_every``; ``device`` and ``group`` as ``configure`` takes them."""
    args, device, policy, cfg = configure(argv, device, group)
    if args.phase != "finetune":
        raise SystemExit("prepare_finetune builds --phase finetune")
    n_class = args.n_class if args.d == 2 else 1
    if args.synthetic:
        def loader():
            return SyntheticLoader(args.b // args.world, args.steps_per_epoch or 4,
                                   mesh.rank_seed(args.seed, args.rank), dim=args.d,
                                   canvas=args.chest_canvas or 224,
                                   n_class=n_class if args.d == 2 else 0)
        loaders = {"train": loader(), "eval": loader() if args.eval_every > 0 else None}
    else:
        loaders = (luna_finetune_loaders if args.d == 3 else chest_finetune_loaders)(args)
        if args.steps_per_epoch is not None:
            loaders["train"] = Capped(loaders["train"], args.steps_per_epoch)
    return cfg, loaders, device, {"dim": args.d, "n_class": n_class, "policy": policy,
                                  "weight": args.weight}


def gpu_ids(args) -> list:
    """The device indices ``--gpus`` lists (``0`` when it lists none)."""
    return [int(g) for g in str(args.gpus).split(",") if g.strip()] or [0]


def devices_used(args) -> int:
    """How many devices the run uses, as the JAX CLI counts them:
    min(``--gpus``' length, the CUDA devices there are); with ``--device
    cpu`` every listed one, as a gloo process."""
    listed = len(gpu_ids(args))
    if torch.device(args.device).type != "cuda":
        return listed
    return max(1, min(listed, torch.cuda.device_count()))


def rank_device(args, rank: int) -> torch.device:
    """Rank ``rank``'s device: the ``rank``-th GPU ``--gpus`` lists (on
    ``--device cuda``), else ``--device`` as given."""
    if args.device != "cuda":
        return resolve_device(args.device)
    resolve_device("cuda")  # raises without a CUDA device
    index = gpu_ids(args)[rank]
    if index >= torch.cuda.device_count():
        raise SystemExit(f"--gpus lists device {index}; this machine has "
                         f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def run(argv, device: torch.device, group=None):
    """One rank's run of ``argv`` on ``device`` in ``group``: the
    ``Trainer`` (pretask) or the ``FinetuneTrainer``."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if build_parser().parse_args(argv).phase == "finetune":
        cfg, loaders, device, options = prepare_finetune(argv, device, group)
        print(f"finetuning pcrlv2 {options['dim']}d (n_class={options['n_class']}) "
              f"on {device}")
        return run_finetune(cfg, loaders["train"], eval_loader=loaders["eval"],
                            device=device, group=group, **options)
    model, cfg, loaders, aug_fn, device = prepare(argv, device, group)
    print(f"training pcrlv2 {model.dim}d on {device}")
    return run_training(model, cfg, loaders["train"], aug_fn, device,
                        eval_loader=loaders["eval"], group=group)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(argv, rank: int, world: int, port: int) -> None:
    """A process ``spawn_ranks`` starts: rank ``rank`` of ``world``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    args = build_parser().parse_args(argv)
    device = rank_device(args, rank)
    group = mesh.init_distributed(device)
    try:
        run(argv, device, group)
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(argv, world: int) -> None:
    """Run ``argv`` as ``world`` processes (spawned, one per device) in one
    process group on this host, and wait for them; if one fails, stop the
    others and raise ``SystemExit``."""
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(argv, r, world, port), name=f"rank{r}")
             for r in range(world)]
    for p in procs:
        p.start()
    failed = None
    try:
        running = list(procs)
        while running and failed is None:
            wait([p.sentinel for p in running])
            for p in [p for p in running if not p.is_alive()]:
                running.remove(p)
                if p.exitcode != 0 and failed is None:
                    failed = p
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    if failed is not None:
        raise SystemExit(f"{failed.name} of {world} failed (exit code {failed.exitcode})")


def main(argv=None):
    """Train as ``argv`` says; returns the ``Trainer`` (pretask) or the
    ``FinetuneTrainer`` of this process.  ``--multihost`` joins torchrun's
    process group; else, when ``--gpus`` lists more than one device there
    is, one process per device is spawned (None is returned)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    refuse(args)
    if args.multihost:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
                  if args.device == "cuda" else resolve_device(args.device))
        group = mesh.init_distributed(device)
        print(f"==> multihost: process {mesh.rank(group)} of {mesh.world(group)} on {device}")
        return run(argv, device, group)
    world = devices_used(args)
    print(f"==> data parallel: {world} device(s) of the {len(gpu_ids(args))} --gpus lists")
    if world == 1:
        return run(argv, rank_device(args, 0))
    if args.b % world:
        raise SystemExit(f"batch {args.b} not divisible by {world} data-parallel devices")
    if "RANK" in os.environ:
        raise SystemExit("a launcher's environment is set (RANK): pass --multihost to join "
                         "its process group")
    spawn_ranks(argv, world)
    return None


if __name__ == "__main__":
    main()
