"""Epoch loop of 3D pretraining (port of ``pcrlv2_tpu/train/trainer.py``;
reference ``train_3d.py:42-83``): cosine LR per epoch, augmentation and one
train step per batch, meters every ``log_every`` steps, and reference-schema
``.pt`` checkpoints at ``epoch % 100 == 0`` or ``epoch == 240`` named
``{model}_{n}_{phase}_{ratio}_{epoch}.pt``.

Randomness comes from two generators seeded from ``seed``: one on the device
for the augmentation, one on the host for the SimSiam levels.  Evaluation and
resume are not ported yet (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import torch

from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.train.checkpoint import export_pcrlv23d
from pcrlv2_tpu_torch.train.optimizer import cosine_lr
from pcrlv2_tpu_torch.train.step import TrainState, train_step
from pcrlv2_tpu_torch.utils.meters import AverageMeter, MetricLogger

#: SimSiam levels the step samples from (the three decoder stages)
N_LEVELS = 3
_LOSSES = ("cos_loss", "mg_loss", "local_loss", "loss")


@dataclass
class TrainConfig:
    """Hyperparameters of reference ``main.py:22-40`` that this slice uses."""

    model: str = "pcrlv2"
    n: str = "luna"
    phase: str = "pretask"
    b: int = 16
    epochs: int = 240
    lr: float = 1e-3
    output: str = "./out"
    ratio: float = 1.0
    momentum: float = 0.9
    weight_decay: float = 1e-4
    seed: int = 42
    amp: bool = False
    log_every: int = 10

    def __post_init__(self):
        self.log_every = max(1, int(self.log_every))

    def ckpt_name(self, epoch: int) -> str:
        return f"{self.model}_{self.n}_{self.phase}_{self.ratio}_{epoch}.pt"


class Trainer:
    """Drives the train step over epochs on ``device`` (default: CUDA)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, aug_fn,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.state = TrainState(model, cfg.momentum, cfg.weight_decay)
        self.aug_fn = aug_fn
        self.aug_gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.level_gen = torch.Generator().manual_seed(cfg.seed)
        os.makedirs(cfg.output, exist_ok=True)
        self.logger = MetricLogger(os.path.join(cfg.output, "metrics.jsonl"))

    def draw_levels(self, n_views: int) -> list:
        """The 1 + 2·V SimSiam levels of one step."""
        return torch.randint(0, N_LEVELS, (1 + 2 * n_views,),
                             generator=self.level_gen).tolist()

    def train_epoch(self, epoch: int, batch_iter) -> dict:
        cfg = self.cfg
        lr = cosine_lr(epoch, cfg.lr, cfg.epochs)
        meters = {k: AverageMeter() for k in ("batch_time", "data_time") + _LOSSES}
        end = win_start = time.time()
        idx, metrics = -1, None
        for idx, raw in enumerate(batch_iter):
            meters["data_time"].update(time.time() - end)
            batch = {k: torch.as_tensor(v).to(self.device) for k, v in raw.items()}
            views = self.aug_fn(self.aug_gen, batch)
            levels = self.draw_levels(views["locals"].shape[1])
            # the step reads the loss on the host (finite-loss guard), so
            # the device has finished the step when it returns
            metrics = train_step(self.state, views, levels, lr, epoch)
            if (idx + 1) % cfg.log_every == 0:
                for k in _LOSSES:
                    meters[k].update(float(metrics[k]), cfg.b)
                now = time.time()
                meters["batch_time"].update((now - win_start) / cfg.log_every,
                                            cfg.log_every)
                win_start = now
                self.logger.log({
                    "epoch": epoch, "iter": idx + 1, "lr": lr,
                    "BT": meters["batch_time"].avg, "DT": meters["data_time"].avg,
                    "skipped": metrics["skipped"],
                    **{k: meters[k].avg for k in _LOSSES}})
            end = time.time()
        if meters["loss"].count == 0 and idx >= 0:
            # epoch shorter than log_every: report the last step's losses
            for k in _LOSSES:
                meters[k].update(float(metrics[k]), cfg.b)
        return {k: m.avg for k, m in meters.items()}

    def save_reference_ckpt(self, epoch: int) -> str:
        path = os.path.join(self.cfg.output, self.cfg.ckpt_name(epoch))
        export_pcrlv23d(self.state.model, path, opt=vars(self.cfg), epoch=epoch)
        return path


def run_training(model: torch.nn.Module, cfg: TrainConfig, loader, aug_fn,
                 device=None) -> Trainer:
    """Epochs 0..cfg.epochs (reference epoch loop ``train_3d.py:60-83``)."""
    trainer = Trainer(model, cfg, aug_fn, device)
    try:
        for epoch in range(cfg.epochs + 1):
            print("==> training...")
            t0 = time.time()
            stats = trainer.train_epoch(epoch, loader.epoch(epoch))
            epoch_time = time.time() - t0
            print(f"epoch {epoch}, total time {epoch_time:.2f}")
            trainer.logger.log({"epoch": epoch, "epoch_time": epoch_time, **stats},
                               console=False)
            if epoch % 100 == 0 or epoch == 240:
                print("==> Saving...")
                trainer.save_reference_ckpt(epoch)
    finally:
        trainer.logger.close()
    return trainer
