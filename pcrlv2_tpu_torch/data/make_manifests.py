"""Generate ``train_val_txt`` manifests from a dataset tree (port of
``pcrlv2_tpu/data/make_manifests.py``).

The reference ships its lists as release artifacts (reference
``train_val_txt/``: ``chest_train.txt`` 78,468 lines of
``img.png l1 … l14``, ``luna_train.txt`` 623 series UIDs — consumed at
reference ``utils.py:7-27``); a dataset tree carries the same information:

* LUNA: the series UIDs under ``subset{0..9}``, of the raw tree (``*.mhd``)
  or the preprocessed one (``{uid}_global_{k}.npy``).
* Chest: the ``.png/.jpg/.jpeg`` files under an image directory, split into
  train/valid/test.  Labels are written as 14 zeros — the pretraining
  pipelines never read them (reference ``chestDataset.py`` uses images
  only); regenerate from the NIH ``Data_Entry_2017.csv`` for real labels.

CLI::

    python -m pcrlv2_tpu_torch.data.make_manifests --n luna  --data /data/luna  --out train_val_txt
    python -m pcrlv2_tpu_torch.data.make_manifests --n chest --data /data/nih/images --out train_val_txt
"""

from __future__ import annotations

import argparse
import os
from typing import List, Sequence, Tuple

import numpy as np

CHEST_EXTS = (".png", ".jpg", ".jpeg")
N_CHEST_LABELS = 14


def luna_uids_from_tree(data_dir: str) -> List[str]:
    """Series UIDs under ``subset{0..9}`` (raw ``.mhd`` or ``_global_``
    npy files), sorted."""
    uids = set()
    for i in range(10):
        subset = os.path.join(data_dir, f"subset{i}")
        if not os.path.isdir(subset):
            continue
        for fname in os.listdir(subset):
            if fname.endswith(".mhd"):
                uids.add(fname[: -len(".mhd")])
            elif "_global_" in fname and fname.endswith(".npy"):
                uids.add(fname.split("_")[0])
    return sorted(uids)


def write_luna_manifest(data_dir: str, out_path: str) -> List[str]:
    """Write the tree's UIDs to ``out_path``, one per line; tmp + rename, so
    a reader never sees a partial list."""
    uids = luna_uids_from_tree(data_dir)
    if not uids:
        raise SystemExit(f"no LUNA series found under {data_dir} "
                         "(expected subset{0..9}/*.mhd or *_global_*.npy)")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("\n".join(uids) + "\n")
    os.replace(tmp, out_path)
    return uids


def chest_images_from_dir(data_dir: str, exts: Sequence[str] = CHEST_EXTS) -> List[str]:
    """Relative image paths under ``data_dir`` (recursive), sorted."""
    names = []
    for root, _dirs, files in os.walk(data_dir):
        rel = os.path.relpath(root, data_dir)
        for fname in files:
            if fname.lower().endswith(tuple(exts)):
                names.append(fname if rel == "." else os.path.join(rel, fname))
    return sorted(names)


def write_chest_manifests(data_dir: str, out_dir: str,
                          splits: Tuple[float, float] = (0.78, 0.11),
                          seed: int = 0) -> Tuple[List[str], List[str], List[str]]:
    """Write ``chest_{train,valid,test}.txt`` with zeroed labels, each split
    in name order; ``splits`` = (train, valid) fractions of one
    ``RandomState(seed)`` permutation, test the rest (the reference's
    78,468 / 11,218 / 11,218 proportions by default)."""
    names = chest_images_from_dir(data_dir)
    if not names:
        raise SystemExit(f"no chest images found under {data_dir}")
    order = np.random.RandomState(seed).permutation(len(names))
    n_train = int(len(names) * splits[0])
    n_valid = int(len(names) * splits[1])
    idx = {"train": order[:n_train], "valid": order[n_train:n_train + n_valid],
           "test": order[n_train + n_valid:]}
    os.makedirs(out_dir, exist_ok=True)
    zeros = " ".join(["0"] * N_CHEST_LABELS)
    out = {}
    for split, ids in idx.items():
        split_names = [names[i] for i in sorted(ids)]
        with open(os.path.join(out_dir, f"chest_{split}.txt"), "w") as f:
            f.writelines(f"{n} {zeros}\n" for n in split_names)
        out[split] = split_names
    return out["train"], out["valid"], out["test"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Generate train_val_txt manifests from a "
                                            "dataset tree.")
    p.add_argument("--n", required=True, choices=("luna", "chest"))
    p.add_argument("--data", required=True, help="dataset root to scan")
    p.add_argument("--out", default="train_val_txt", help="output dir")
    p.add_argument("--seed", default=0, type=int, help="chest split shuffle")
    p.add_argument("--train_frac", default=0.78, type=float)
    p.add_argument("--valid_frac", default=0.11, type=float)
    args = p.parse_args(argv)
    if args.n == "luna":
        out_path = os.path.join(args.out, "luna_train.txt")
        uids = write_luna_manifest(args.data, out_path)
        print(f"wrote {len(uids)} UIDs to {out_path}")
    else:
        tr, va, te = write_chest_manifests(args.data, args.out,
                                           splits=(args.train_frac, args.valid_frac),
                                           seed=args.seed)
        print(f"wrote chest_train/valid/test.txt to {args.out}: "
              f"{len(tr)}/{len(va)}/{len(te)} images")


if __name__ == "__main__":
    main()
