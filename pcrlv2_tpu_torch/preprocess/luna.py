"""LUNA16 crop-pair generation — the reference's offline stage, vectorized
(port of ``pcrlv2_tpu/preprocess/luna.py``: the same seeding, padding and
quirks, so both write the same files byte for byte).

Behavior parity with reference ``luna_preprocess.py`` (C10, SURVEY.md §2.1):

* HU clip to [-1000, 1000] → [0, 1] (``:135-137``).
* ``crop_pair``: two random crops from the size menu
  [(96,96,64), (96,96,96), (112,112,64), (64,64,32)] with borders 70 (xy) /
  15 (z), rejection-sampled until pairwise IoU > 0.3 (``:167-191``), resized
  to 64×64×(32+len_depth) (``:203-212``).
* thickness/depth maps over ``len_depth=3`` with HU threshold 0.425
  (``:213-243``) — the reference computes these with a 4-deep pure-Python
  loop over ~393k voxels per crop (its preprocessing bottleneck, SURVEY.md
  §3.3); here both maps are one vectorized stride-window pass.
* air/empty-crop rejection: ``sum(d_img) > lung_max·vol`` (``:245-249``,
  ``lung_max=0.15`` per the constructor call at ``:122``).  Reference quirk
  kept: the volume bound uses *crop 1's* dimensions for both windows
  (``:245-248``).
* 6 local crops sampled from the ±3-dilated union bbox of the pair, size menu
  [(32,32,16), (16,16,16), (32,32,32), (8,8,8)], resized to 16³ (``:250-275``).
* ``scale`` pairs per volume, saved as ``{uid}_global_{k}.npy`` (2,64,64,32)
  and ``{uid}_local_{k}.npy`` (6,16,16,16) (``:139-148``).
* process pool over subset folds (``:350-351``).

Deviations (documented):

* Volumes too thin for the z-border (< 64+3+1+2·15 slices) are zero-padded at
  the end of z to the minimum usable depth.  The reference's pad call builds a
  malformed ``np.pad`` width ([0, 0, n] — not broadcastable to (3, 2)) and
  would crash on such volumes; this is a bug fix, not a behavior change.
* ``resize3d`` is an axis-separable linear resize with skimage's
  center-aligned coordinate convention and a Gaussian anti-alias prefilter on
  downsampling (skimage ``transform.resize`` defaults); numerics agree to the
  interpolation-order tolerance, not bit-exactly.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

COL_SIZE = [(96, 96, 64), (96, 96, 96), (112, 112, 64), (64, 64, 32)]
LOCAL_COL_SIZE = [(32, 32, 16), (16, 16, 16), (32, 32, 32), (8, 8, 8)]


@dataclass
class PreprocessConfig:
    """Derived constants (reference ``setup_config``, ``luna_preprocess.py:63-125``)."""

    input_rows: int = 64
    input_cols: int = 64
    input_deps: int = 32
    crop_rows: int = 64
    crop_cols: int = 64
    len_border: int = 70
    len_border_z: int = 15
    len_depth: int = 3
    lung_min: float = 0.7
    lung_max: float = 0.15
    scale: int = 16
    local_input: Tuple[int, int, int] = (16, 16, 16)
    n_locals: int = 6
    hu_min: float = -1000.0
    hu_max: float = 1000.0
    data_dir: str = ""
    save_dir: str = ""
    train_fold: Sequence[int] = field(default_factory=lambda: [0, 1, 2, 3, 4])
    valid_fold: Sequence[int] = field(default_factory=lambda: [5, 6])
    test_fold: Sequence[int] = field(default_factory=lambda: [7, 8, 9])

    @property
    def hu_thred(self) -> float:
        return (-150.0 - self.hu_min) / (self.hu_max - self.hu_min)


def normalize_hu(img: np.ndarray, hu_min=-1000.0, hu_max=1000.0) -> np.ndarray:
    """Clip to the HU window and scale to [0, 1] (reference ``:135-137``)."""
    img = np.clip(img.astype(np.float32), hu_min, hu_max)
    return (img - hu_min) / (hu_max - hu_min)


def cal_iou(box1, box2) -> float:
    """3D IoU of (x0, x1, y0, y1, z0, z1) boxes (reference ``:295-319``)."""
    x0a, x1a, y0a, y1a, z0a, z1a = box1
    x0b, x1b, y0b, y1b, z0b, z1b = box2
    va = (x1a - x0a) * (y1a - y0a) * (z1a - z0a)
    vb = (x1b - x0b) * (y1b - y0b) * (z1b - z0b)
    w = max(0, min(x1a, x1b) - max(x0a, x0b))
    h = max(0, min(y1a, y1b) - max(y0a, y0b))
    d = max(0, min(z1a, z1b) - max(z0a, z0b))
    inter = w * h * d
    return inter / (va + vb - inter)


# ---------------------------------------------------------------------------
# resize (skimage.transform.resize equivalent)
# ---------------------------------------------------------------------------


def _gaussian_1d(arr: np.ndarray, axis: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return arr
    radius = max(1, int(4.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    arr = np.moveaxis(arr, axis, -1)
    padded = np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(radius, radius)],
                    mode="reflect")
    # windowed matmul: (…, n+2r) → (…, n) via strided windows · kernel
    windows = np.lib.stride_tricks.sliding_window_view(padded, 2 * radius + 1,
                                                       axis=-1)
    out = windows @ k
    return np.moveaxis(out, -1, axis)


def _linear_resize_axis(arr: np.ndarray, axis: int, out_n: int) -> np.ndarray:
    in_n = arr.shape[axis]
    if in_n == out_n:
        return arr
    scale = in_n / out_n
    coords = (np.arange(out_n, dtype=np.float64) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0, in_n - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_n - 1)
    frac = (coords - lo).astype(np.float32)
    a = np.take(arr, lo, axis=axis)
    b = np.take(arr, hi, axis=axis)
    shape = [1] * arr.ndim
    shape[axis] = out_n
    return a + (b - a) * frac.reshape(shape)


def resize3d(arr: np.ndarray, out_shape: Sequence[int],
             anti_alias: bool = True) -> np.ndarray:
    """Separable linear 3D resize, skimage ``resize`` semantics
    (center-aligned sampling + Gaussian prefilter when downsampling)."""
    arr = arr.astype(np.float32)
    if anti_alias:
        for axis in range(3):
            factor = arr.shape[axis] / out_shape[axis]
            if factor > 1:
                arr = _gaussian_1d(arr, axis, (factor - 1) / 2.0)
    for axis in range(3):
        arr = _linear_resize_axis(arr, axis, out_shape[axis])
    return arr


# ---------------------------------------------------------------------------
# thickness / depth maps — vectorized (kills the reference's Python hot loop)
# ---------------------------------------------------------------------------


def thickness_maps(window: np.ndarray, hu_thred: float, input_depth: int,
                   len_depth: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-voxel first-above-threshold scan over ``len_depth`` z-neighbors.

    Reference semantics (``luna_preprocess.py:217-243``): for output voxel
    (i, j, d), find the first k ∈ [0, len_depth) with
    ``window[i, j, d+k] ≥ hu_thred``; ``t_img`` holds that value (0 if none),
    raw depth is k (or len_depth−1 if none), then
    ``d_img = 1 − raw/(len_depth−1)``.

    One strided-window pass instead of the reference's 4-deep Python loop —
    ~5 orders of magnitude fewer interpreter operations per crop.
    """
    # (rows, cols, input_depth, len_depth) sliding z-windows
    sw = np.lib.stride_tricks.sliding_window_view(window, len_depth, axis=2)
    sw = sw[:, :, :input_depth]
    above = sw >= hu_thred
    any_above = above.any(axis=-1)
    first = np.argmax(above, axis=-1)          # 0 when none above — fix below
    raw_depth = np.where(any_above, first, len_depth - 1)
    t_img = np.where(
        any_above,
        np.take_along_axis(sw, first[..., None], axis=-1)[..., 0],
        0.0,
    ).astype(np.float32)
    d_img = 1.0 - raw_depth.astype(np.float32) / (len_depth - 1)
    return t_img, d_img


# ---------------------------------------------------------------------------
# crop-pair generation
# ---------------------------------------------------------------------------


def _pad_thin_volume(img: np.ndarray, cfg: PreprocessConfig) -> np.ndarray:
    """Zero-pad z so the crop window + borders fit (see module docstring —
    the reference's pad call is malformed and would crash here)."""
    min_z = 64 + cfg.len_depth + 1 + 2 * cfg.len_border_z + 1
    if img.shape[2] >= min_z:
        return img
    return np.pad(img, ((0, 0), (0, 0), (0, min_z - img.shape[2])),
                  mode="constant")


def _sample_box(rng: random.Random, np_rng: np.random.RandomState,
                shape, cfg: PreprocessConfig):
    size_x, size_y, size_z = shape
    for _ in range(64):
        rows, cols, deps = COL_SIZE[np_rng.randint(0, len(COL_SIZE))]
        if size_x - rows - 1 - cfg.len_border <= cfg.len_border:
            rows -= 32
            cols -= 32
        x_hi = size_x - rows - 1 - cfg.len_border
        y_hi = size_y - cols - 1 - cfg.len_border
        z_hi = size_z - deps - cfg.len_depth - 1 - cfg.len_border_z
        if x_hi < cfg.len_border or y_hi < cfg.len_border or \
                z_hi < cfg.len_border_z:
            # this menu size does not fit the volume — resample.  The
            # reference crashes here (empty randint range); on real 1mm LUNA
            # volumes every size fits, so the sampling distribution matches.
            continue
        x0 = rng.randint(cfg.len_border, x_hi)
        y0 = rng.randint(cfg.len_border, y_hi)
        z0 = rng.randint(cfg.len_border_z, z_hi)
        return (x0, x0 + rows, y0, y0 + cols, z0, z0 + deps)
    raise ValueError(f"no crop size from {COL_SIZE} fits volume {shape}")


def crop_pair(img: np.ndarray, cfg: PreprocessConfig,
              rng: random.Random | None = None,
              np_rng: np.random.RandomState | None = None):
    """One IoU-constrained multi-scale crop pair + 6 local crops
    (reference ``crop_pair``, ``luna_preprocess.py:151-275``).

    Returns ``(crop1 (64,64,32), crop2 (64,64,32), locals (6,16,16,16))``.
    """
    rng = rng or random
    np_rng = np_rng or np.random
    img = _pad_thin_volume(img, cfg)
    size_x, size_y, size_z = img.shape
    out_rows, out_cols, out_deps = cfg.input_rows, cfg.input_cols, cfg.input_deps

    while True:
        # rejection-sample boxes until IoU > 0.3 (reference ``:167-191``)
        while True:
            box1 = _sample_box(rng, np_rng, img.shape, cfg)
            box2 = _sample_box(rng, np_rng, img.shape, cfg)
            if cal_iou(box1, box2) > 0.3:
                break

        windows = []
        ok = True
        for box in (box1, box2):
            x0, x1, y0, y1, z0, z1 = box
            w = img[x0:x1, y0:y1, z0:z1 + cfg.len_depth]
            if w.shape != (out_rows, out_cols, out_deps + cfg.len_depth):
                w = resize3d(w, (out_rows, out_cols, out_deps + cfg.len_depth))
            windows.append(w)
        # air/empty filter on the depth map (reference ``:245-249``; bound uses
        # crop 1's raw dims for both windows — quirk kept)
        vol1 = ((box1[1] - box1[0]) * (box1[3] - box1[2])
                * (box1[5] - box1[4]))
        for w in windows:
            _, d_img = thickness_maps(w, cfg.hu_thred, out_deps, cfg.len_depth)
            if d_img.sum() > cfg.lung_max * vol1:
                ok = False
                break
        if not ok:
            continue

        # local crops from the ±3-dilated union bbox (reference ``:250-275``)
        x_min, x_max = min(box1[0], box2[0]), max(box1[1], box2[1])
        y_min, y_max = min(box1[2], box2[2]), max(box1[3], box2[3])
        z_min, z_max = min(box1[4], box2[4]), max(box1[5], box2[5])
        locals_ = []
        for _ in range(cfg.n_locals):
            lx = np_rng.randint(max(x_min - 3, 0), min(x_max + 3, size_x))
            ly = np_rng.randint(max(y_min - 3, 0), min(y_max + 3, size_y))
            lz = np_rng.randint(max(z_min - 3, 0), min(z_max + 3, size_z))
            lr, lc, ld = LOCAL_COL_SIZE[np_rng.randint(0, len(LOCAL_COL_SIZE))]
            w = img[lx:lx + lr, ly:ly + lc, lz:lz + ld]
            locals_.append(resize3d(w, cfg.local_input))
        return (windows[0][:, :, :out_deps], windows[1][:, :, :out_deps],
                np.stack(locals_, axis=0))


def generate_pairs_from_volume(img: np.ndarray, save_dir: str, name: str,
                               cfg: PreprocessConfig,
                               rng: random.Random | None = None,
                               np_rng: np.random.RandomState | None = None) -> int:
    """``scale`` crop pairs from one normalized volume → npy files
    (reference ``infinite_generator_from_one_volume``, ``:134-148``)."""
    img = normalize_hu(img, cfg.hu_min, cfg.hu_max)
    for k in range(cfg.scale):
        c1, c2, loc = crop_pair(img, cfg, rng, np_rng)
        np.save(os.path.join(save_dir, f"{name}_global_{k}.npy"),
                np.stack((c1, c2), axis=0).astype(np.float32))
        np.save(os.path.join(save_dir, f"{name}_local_{k}.npy"),
                loc.astype(np.float32))
    return cfg.scale


def process_subset(args) -> int:
    """Worker: all volumes of one LUNA subset (reference ``:278-292``)."""
    subset_idx, cfg_dict = args
    cfg = PreprocessConfig(**cfg_dict)
    from pcrlv2_tpu_torch.preprocess.mhd import load_volume_1mm

    subset_dir = os.path.join(cfg.data_dir, f"subset{subset_idx}")
    if not os.path.isdir(subset_dir):
        # partial download / smoke tree: the no---fold CLI sweeps all 10
        # subsets, and absent ones should be skipped, not crash the Pool
        print(f"subset{subset_idx}: not present, skipping")
        return 0
    save_dir = os.path.join(cfg.save_dir, f"subset{subset_idx}")
    os.makedirs(save_dir, exist_ok=True)
    n = 0
    mhds = sorted(f for f in os.listdir(subset_dir) if f.endswith(".mhd"))
    rng = random.Random(1)
    np_rng = np.random.RandomState(1 + subset_idx)
    for fname in mhds:
        vol = load_volume_1mm(os.path.join(subset_dir, fname))
        n += generate_pairs_from_volume(vol, save_dir, fname[:-4], cfg,
                                        rng, np_rng)
    return n


def process_subsets(cfg: PreprocessConfig, subsets: Sequence[int] = range(10),
                    n_procs: int = 5) -> int:
    """Fan the subsets over a process pool (reference ``Pool(5)``, ``:350``),
    its workers spawned: the caller may run threads, which a fork would
    copy in whatever state they hold."""
    import multiprocessing as mp

    cfg_dict = {k: v for k, v in vars(cfg).items()}
    jobs = [(i, cfg_dict) for i in subsets]
    if n_procs <= 1:
        return sum(process_subset(j) for j in jobs)
    with mp.get_context("spawn").Pool(n_procs) as pool:
        return sum(pool.map(process_subset, jobs))
