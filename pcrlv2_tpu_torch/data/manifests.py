"""File lists with the reference's conventions (copy of
``pcrlv2_tpu/data/manifests.py``; reference ``utils.py:7-57``).

* ``chest_train.txt`` — lines of ``img.png l1 … l14`` (14 binary labels)
* ``luna_train.txt``  — one LUNA series UID per line
* processed LUNA tree — ``subset{0..9}/{uid}_global_{k}.npy`` (2, 64, 64, 32)
  and ``{uid}_local_{k}.npy`` (6, 16, 16, 16)
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def get_chest_list(txt_path: str, data_dir: str) -> Tuple[List[str], List[List[int]]]:
    """Image paths under ``data_dir`` and their labels from ``name + 14 binary
    labels`` lines (reference ``utils.py:7-19``)."""
    image_names, labels = [], []
    with open(txt_path) as f:
        for line in f:
            items = line.split()
            if not items:
                continue
            image_names.append(os.path.join(data_dir, items[0]))
            labels.append([int(i) for i in items[1:]])
    return image_names, labels


def get_luna_pretrain_list(ratio: float,
                           txt_path: str = "train_val_txt/luna_train.txt") -> List[str]:
    """Top-``ratio`` of the LUNA train UIDs (reference ``utils.py:22-27``)."""
    with open(txt_path) as f:
        uids = [line.strip("\n") for line in f if line.strip()]
    return uids[: int(len(uids) * ratio)]


def get_luna_finetune_list(ratio: float,
                           txt_path: str = "train_val_txt/luna_train.txt") -> List[str]:
    """The UIDs after the top ``ratio``: the complement of the pretrain split,
    which finetuning trains on (reference ``utils.py:30-35``)."""
    with open(txt_path) as f:
        uids = [line.strip("\n") for line in f if line.strip()]
    return uids[int(len(uids) * ratio):]


def get_luna_list(data_dir: str, train_fold: Sequence[int], valid_fold: Sequence[int],
                  test_fold: Sequence[int], suffix: str = "_global_",
                  file_list: Sequence[str] | None = None
                  ) -> Tuple[List[str], List[str], List[str]]:
    """Files containing ``suffix`` in ``subset{i}`` of each fold, sorted per
    subset, train filtered by the UID list (reference ``utils.py:38-57``;
    folds 0-6 train, 7-9 valid per ``data.py:67-68``)."""

    def scan(folds, filt):
        out = []
        for i in folds:
            subset = os.path.join(data_dir, f"subset{i}")
            if not os.path.isdir(subset):
                continue
            for fname in sorted(os.listdir(subset)):
                if suffix not in fname:
                    continue
                if filt is None or fname.split("_")[0] in filt:
                    out.append(os.path.join(subset, fname))
        return out

    uid_set = set(file_list) if file_list is not None else None
    return scan(train_fold, uid_set), scan(valid_fold, None), scan(test_fold, None)
