"""Command-line entry point of the port (flag names of reference ``main.py``
and ``pcrlv2_tpu/cli/main.py``).

    python -m pcrlv2_tpu_torch.cli.main --synthetic --d 3 --phase pretask \
        [--amp] [--device cpu] [--b 4 --epochs 0 --steps_per_epoch 3]

Runs 3D LUNA pretraining on one CUDA device (``--device cpu`` only when
asked).  Paths not ported yet stop with the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse

from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
from pcrlv2_tpu_torch.data.pipeline import synthetic_luna_batch
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train.trainer import TrainConfig, run_training


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PCRLv2 pretraining (PyTorch/CUDA)")
    parser.add_argument("--data", metavar="DIR", default=None,
                        help="processed LUNA tree (not ported yet)")
    parser.add_argument("--model", default="pcrlv2")
    parser.add_argument("--phase", default="pretask", help="pretask | finetune")
    parser.add_argument("--b", default=16, type=int, help="batch size")
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--output", default="./out", help="checkpoint dir")
    parser.add_argument("--n", default="luna", help="dataset name")
    parser.add_argument("--d", default=3, type=int, help="2d or 3d pipeline")
    parser.add_argument("--gpus", default="0", help="device list (one device)")
    parser.add_argument("--ratio", default=1.0, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight_decay", default=1e-4, type=float)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--amp", action="store_true", default=False,
                        help="bf16 compute, f32 parameters")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--synthetic", action="store_true", default=False,
                        help="train on synthetic data")
    parser.add_argument("--steps_per_epoch", default=None, type=int,
                        help="batches per epoch of synthetic data (default 4)")
    parser.add_argument("--log_every", default=10, type=int)
    parser.add_argument("--resume", default=None, help="(not ported yet)")
    parser.add_argument("--mixup", default=None, type=float, help="(not ported yet)")
    parser.add_argument("--spatial", default=1, type=int, help="(not ported yet)")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="(not ported yet)")
    return parser


def _not_ported(what: str, item: str):
    raise SystemExit(f"{what} is not ported yet (ROADMAP Queue A item {item})")


class SyntheticLoader:
    """``steps`` in-memory raw batches per epoch, seeded per batch as the JAX
    CLI's synthetic loader does."""

    def __init__(self, batch_size: int, steps: int, seed: int):
        self.batch_size, self.steps, self.seed = batch_size, steps, seed

    def epoch(self, epoch: int):
        for i in range(self.steps):
            yield synthetic_luna_batch(
                self.batch_size, seed=self.seed + epoch * self.steps + i)


def prepare(argv=None):
    """Parse ``argv`` and build what ``main`` trains: ``(model, cfg, loader,
    aug_fn, device)`` for ``run_training``."""
    args = build_parser().parse_args(argv)
    if args.d != 3:
        _not_ported(f"--d {args.d}", "8 (2D chest path)")
    if args.model != "pcrlv2" or args.phase not in ("pretask", "finetune"):
        raise SystemExit(f"no trainer for (model={args.model}, phase={args.phase})")
    if args.phase == "finetune":
        _not_ported("--phase finetune", "9")
    if not args.synthetic:
        _not_ported("--data (the LUNA reader)", "6; pass --synthetic")
    if args.spatial > 1:
        _not_ported("--spatial", "11")
    if args.multihost or len([g for g in str(args.gpus).split(",") if g]) > 1:
        _not_ported("training on more than one device", "7")
    if args.resume:
        _not_ported("--resume", "6")
    if args.mixup is not None:
        _not_ported("--mixup", "12")

    device = resolve_device(args.device)
    policy = DEFAULT_POLICY if args.amp else PARITY_POLICY
    cfg = TrainConfig(model=args.model, n=args.n, phase=args.phase, b=args.b,
                      epochs=args.epochs, lr=args.lr, output=args.output,
                      ratio=args.ratio, momentum=args.momentum,
                      weight_decay=args.weight_decay, seed=args.seed,
                      amp=args.amp, log_every=args.log_every)
    model = PCRLv23d(policy=policy, seed=args.seed, device=device)
    loader = SyntheticLoader(args.b, args.steps_per_epoch or 4, args.seed)
    return model, cfg, loader, make_luna_aug_fn(), device


def main(argv=None) -> None:
    model, cfg, loader, aug_fn, device = prepare(argv)
    print(f"training pcrlv2 3d on {device}")
    run_training(model, cfg, loader, aug_fn, device)


if __name__ == "__main__":
    main()
