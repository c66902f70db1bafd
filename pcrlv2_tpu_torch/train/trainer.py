"""Epoch loop of 3D pretraining (port of ``pcrlv2_tpu/train/trainer.py``;
reference ``train_3d.py:42-83``): cosine LR per epoch, every loader behind
``device_prefetch``, augmentation and one train step per batch, meters every
``log_every`` steps, a held-out evaluation every ``eval_every`` epochs,
reference-schema ``.pt`` checkpoints at ``epoch % 100 == 0`` or
``epoch == 240`` named ``{model}_{n}_{phase}_{ratio}_{epoch}.pt``, and the
train state at those epochs and every ``save_every`` epochs
(``<output>/train_state``), from which ``resume`` continues.

Randomness comes from two generators seeded from ``seed``: one on the device
for the augmentation, one on the host for the SimSiam levels; both are part
of the train state.  Evaluation draws its levels from a generator seeded by
(seed, batch index), so it is the same on every pass.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.data.pipeline import device_prefetch
from pcrlv2_tpu_torch.train.checkpoint import (export_pcrlv23d, load_train_state,
                                               save_train_state)
from pcrlv2_tpu_torch.train.optimizer import cosine_lr
from pcrlv2_tpu_torch.train.step import TrainState, eval_step, train_step
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
    eval_every: int = 0    # epochs between eval passes; 0 disables
    eval_batches: int = 0  # cap of batches per eval pass; 0 = the whole fold
    save_every: int = 0    # train-state cadence besides the reference epochs
    resume: Optional[str] = None  # train-state directory to continue from

    def __post_init__(self):
        self.log_every = max(1, int(self.log_every))

    def ckpt_name(self, epoch: int) -> str:
        return f"{self.model}_{self.n}_{self.phase}_{self.ratio}_{epoch}.pt"

    @property
    def state_dir(self) -> str:
        """Where the train state is saved (``--resume`` takes this path)."""
        return os.path.join(self.output, "train_state")


def raw_batch_to_views(batch) -> dict:
    """Un-augmented eval views of a raw batch (the JAX trainer's
    ``raw_batch_to_views``): x1 = gt = pair[:, 0], x2 = gt2 = pair[:, 1],
    channels last, in f32."""
    pair, crops = batch["pair"].float(), batch["locals"].float()
    return {"x1": pair[:, 0, ..., None], "x2": pair[:, 1, ..., None],
            "gt": pair[:, 0, ..., None], "gt2": pair[:, 1, ..., None],
            "locals": crops[..., None]}


def eval_levels(seed: int, index: int, n_views: int) -> list:
    """The 1 + 2·V levels of eval batch ``index``, from a generator seeded by
    (seed, index)."""
    key = int(np.random.SeedSequence([seed % 2 ** 32, index]).generate_state(1)[0])
    gen = torch.Generator().manual_seed(key)
    return torch.randint(0, N_LEVELS, (1 + 2 * n_views,), generator=gen).tolist()


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

    def generators(self) -> dict:
        return {"aug": self.aug_gen, "level": self.level_gen}

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
            # the step returns 0-d device tensors and reads nothing back, so
            # the host runs ahead; the metrics are read (a sync) only when
            # they are logged, as the JAX trainer does
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
                    "skipped": float(metrics["skipped"]),
                    **{k: meters[k].avg for k in _LOSSES}})
            end = time.time()
        if meters["loss"].count == 0 and idx >= 0:
            # epoch shorter than log_every: report the last step's losses
            for k in _LOSSES:
                meters[k].update(float(metrics[k]), cfg.b)
        return {k: m.avg for k, m in meters.items()}

    def evaluate(self, batch_iter, max_batches: Optional[int] = None) -> dict:
        """The loss averaged over the eval batches (each weighted by its size;
        the last may be short), at most ``max_batches`` of them (default
        ``cfg.eval_batches``; 0 = all).  Leaves the train state untouched."""
        if max_batches is None:
            max_batches = self.cfg.eval_batches
        meters = {k: AverageMeter() for k in _LOSSES}
        for i, raw in enumerate(batch_iter):
            if max_batches and i >= max_batches:
                break
            views = raw_batch_to_views(
                {k: torch.as_tensor(v).to(self.device) for k, v in raw.items()})
            levels = eval_levels(self.cfg.seed, i, views["locals"].shape[1])
            metrics = eval_step(self.state.model, views, levels)
            for k in meters:
                meters[k].update(float(metrics[k]), views["x1"].shape[0])
        return {k: m.avg for k, m in meters.items()}

    def save_reference_ckpt(self, epoch: int) -> str:
        path = os.path.join(self.cfg.output, self.cfg.ckpt_name(epoch))
        export_pcrlv23d(self.state.model, path, opt=vars(self.cfg), epoch=epoch)
        return path

    def save_state(self, epoch: int) -> str:
        return save_train_state(self.cfg.state_dir, epoch, self.state,
                                self.generators())

    def restore_state(self, state_dir: str) -> int:
        """Load the train state saved in ``state_dir``; returns its epoch."""
        return load_train_state(state_dir, self.state, self.generators())


def run_training(model: torch.nn.Module, cfg: TrainConfig, loader, aug_fn,
                 device=None, eval_loader=None) -> Trainer:
    """Epochs 0..cfg.epochs, or from the epoch after the one saved in
    ``cfg.resume`` (reference epoch loop ``train_3d.py:60-83``; eval and
    save cadence of the JAX trainer, ``trainer.py:419-457``)."""
    trainer = Trainer(model, cfg, aug_fn, device)
    try:
        start = 0
        if cfg.resume:
            start = trainer.restore_state(cfg.resume) + 1
            print(f"==> resumed at epoch {start} (global step {int(trainer.state.step)})")
        for epoch in range(start, cfg.epochs + 1):
            print("==> training...")
            t0 = time.time()
            with contextlib.closing(device_prefetch(loader.epoch(epoch),
                                                    trainer.device)) as batches:
                stats = trainer.train_epoch(epoch, batches)
            epoch_time = time.time() - t0
            print(f"epoch {epoch}, total time {epoch_time:.2f}")
            trainer.logger.log({"epoch": epoch, "epoch_time": epoch_time, **stats},
                               console=False)
            if eval_loader is not None and cfg.eval_every and epoch % cfg.eval_every == 0:
                with contextlib.closing(device_prefetch(eval_loader.epoch(epoch),
                                                        trainer.device)) as batches:
                    ev = trainer.evaluate(batches)
                trainer.logger.log({"epoch": epoch, "eval": ev})
            on_ref_cadence = epoch % 100 == 0 or epoch == 240
            if on_ref_cadence or (cfg.save_every and epoch % cfg.save_every == 0):
                print("==> Saving...")
                if on_ref_cadence:  # .pt files only at the reference epochs
                    trainer.save_reference_ckpt(epoch)
                trainer.save_state(epoch)
    finally:
        trainer.logger.close()
    return trainer
