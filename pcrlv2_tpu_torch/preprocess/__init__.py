"""Offline LUNA16 preprocessing — MHD → 1mm resample → IoU-constrained
multi-scale crop pairs → ``.npy`` (reference ``luna_preprocess.py``; port
of ``pcrlv2_tpu/preprocess``, NumPy and host C++ only)."""

from pcrlv2_tpu_torch.preprocess.mhd import read_mhd, resample_isotropic  # noqa: F401
from pcrlv2_tpu_torch.preprocess.luna import (  # noqa: F401
    PreprocessConfig,
    cal_iou,
    crop_pair,
    generate_pairs_from_volume,
    normalize_hu,
    process_subsets,
    thickness_maps,
)
