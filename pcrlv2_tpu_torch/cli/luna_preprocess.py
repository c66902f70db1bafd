"""LUNA16 offline preprocessing CLI (port of the root ``luna_preprocess.py``,
the same flags and output tree): ``--fold --input_rows --input_cols
--input_deps --crop_rows --crop_cols --data --save --scale --procs``.

MHD → 1mm isotropic resample (the native resampler when the port's library
loads) → HU window → IoU-constrained multi-scale crop pairs →
``subset{i}/{uid}_global_{k}.npy`` (2,64,64,32) and
``{uid}_local_{k}.npy`` (6,16,16,16).  Host only: no GPU is used.

    python -m pcrlv2_tpu_torch.cli.luna_preprocess --data <LUNA16> --save <tree>
"""

import argparse

from pcrlv2_tpu_torch import native
from pcrlv2_tpu_torch.preprocess import PreprocessConfig, process_subsets


def main(argv=None):
    p = argparse.ArgumentParser(description="LUNA16 → crop-pair preprocessing")
    p.add_argument("--fold", type=int, default=None,
                   help="process a single subset (default: all 10)")
    p.add_argument("--input_rows", type=int, default=64)
    p.add_argument("--input_cols", type=int, default=64)
    p.add_argument("--input_deps", type=int, default=32)
    p.add_argument("--crop_rows", type=int, default=64)
    p.add_argument("--crop_cols", type=int, default=64)
    p.add_argument("--data", required=True, help="LUNA16 dataset directory")
    p.add_argument("--save", required=True, help="output directory")
    p.add_argument("--scale", type=int, default=16, help="crop pairs per volume")
    p.add_argument("--procs", type=int, default=5, help="worker processes")
    args = p.parse_args(argv)

    cfg = PreprocessConfig(
        input_rows=args.input_rows, input_cols=args.input_cols,
        input_deps=args.input_deps, crop_rows=args.crop_rows,
        crop_cols=args.crop_cols, scale=args.scale,
        data_dir=args.data, save_dir=args.save,
    )
    if native.available():
        print(f"==> resampler: native ({native.library_path().name})")
    else:
        print(f"==> resampler: NumPy (the native library did not load: {native.build_error()})")
    subsets = [args.fold] if args.fold is not None else list(range(10))
    n = process_subsets(cfg, subsets, n_procs=args.procs)
    print(f"wrote {n} crop pairs")
    return n


if __name__ == "__main__":
    main()
