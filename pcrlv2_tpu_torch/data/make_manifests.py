"""Derive ``luna_train.txt`` from a LUNA tree (copy of the LUNA half of
``pcrlv2_tpu/data/make_manifests.py``).

The reference ships its UID list as a release artifact (reference
``train_val_txt/luna_train.txt``, 623 UIDs); a raw (``*.mhd``) or
preprocessed (``{uid}_global_{k}.npy``) tree carries the same information.
"""

from __future__ import annotations

import os
from typing import List


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
