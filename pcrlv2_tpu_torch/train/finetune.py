"""Downstream finetuning, ``--phase finetune`` (port of
``pcrlv2_tpu/train/finetune.py``; the reference documents the recipe in
``README.md:29-55`` and ships no code for it).

* 2D (chest): ``ChestClassifier`` — the ResNet-18 encoder, GAP over H and W,
  dropout 0.2, a linear ``fc`` in f32 — trained with multi-label BCE on the
  14 NIH labels ``chest_train.txt`` carries.  The saved ``.pt`` is a
  complete torchvision ResNet-18 ``state_dict`` (``fc`` with ``n_class``
  rows).
* 3D (luna): the whole ``PCRLv23d`` at ``local=True``, trained with Dice +
  BCE of its sigmoid output against the batch's ``mask`` (``--mask_dir``)
  or, without one, the intensity-threshold ``pseudo_mask`` of the volume
  (no segmentation ground truth ships with the reference).  The pro/pre
  and mask heads still run and their BN statistics update, but they carry
  no loss, so no gradient reaches them (weight decay and momentum still
  move their parameters, as in the JAX step).

The steps (``finetune_step_2d`` / ``finetune_step_3d``) read nothing back
and draw dropout on a device generator, so on the card the trainer runs
each as a CUDA graph (``train/trainer.py::CapturedStep``), the counterpart
of the JAX package's one jitted program a step; ``cuda_graph=False`` is the
eager loop, and the CPU is always eager.  Evaluation runs eagerly, in eval
mode (no dropout, running BN statistics), ragged tail included, and reads
its results back once.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from pcrlv2_tpu_torch.core import mesh
from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from pcrlv2_tpu_torch.data.pipeline import device_prefetch
from pcrlv2_tpu_torch.models.resnet import ResNet18Encoder
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.ops.convolution import deterministic_cudnn
from pcrlv2_tpu_torch.ops.pooling import global_avg_pool
from pcrlv2_tpu_torch.train.checkpoint import (export_pcrlv23d, import_pcrlv23d,
                                               import_resnet18_encoder,
                                               save_reference_checkpoint)
from pcrlv2_tpu_torch.train.optimizer import cosine_lr
from pcrlv2_tpu_torch.train.step import TrainState, global_mean
from pcrlv2_tpu_torch.train.trainer import GRAPH_WARMUP, CapturedStep, ragged_tail
from pcrlv2_tpu_torch.utils import chiplock
from pcrlv2_tpu_torch.utils.meters import MetricLogger, metrics_path

#: the raw batch entries a finetune step reads (a LUNA batch's local crops
#: are left on the host side of the graph)
STEP_INPUTS = ("image", "label", "pair", "mask")

SCRATCH_WARNING = ("WARNING: finetuning FROM SCRATCH — pass --weight <pretrained.pt> "
                   "(ours or the reference's) for the documented downstream recipe "
                   "(README.md:29-55)")

RESUME_REFUSED = ("--resume is not supported with --phase finetune: its checkpoints are "
                  "reference-schema .pt weight files. Restart from the last saved .pt via "
                  "--weight instead (use --save_every N for a finer checkpoint cadence).")


def apply_dropout(x: torch.Tensor, p: float, gen: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout(p)``: each unit kept where a uniform draw on ``gen``
    (on ``x``'s device) is below 1 − p, the kept ones scaled by 1/(1 − p),
    the rest exactly 0."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class ChestClassifier(nn.Module):
    """ResNet-18 and the smp classification head the README configures
    (``pooling='avg', dropout=0.2, classes=n``, reference ``README.md:31-38``):
    GAP → dropout → linear ``fc``, in f32; the sigmoid is the loss's.

    ``forward(x, dropout_gen)`` with x (B, H, W, 3) returns the (B,
    ``n_class``) logits; a training forward with ``dropout`` > 0 draws its
    mask on ``dropout_gen``.  ``state_dict()`` is ``encoder.*`` (torchvision
    names) and ``fc.weight`` (n_class, 512), ``fc.bias``.  Built on
    ``device`` (default: CUDA, raising without it) with weights drawn from
    ``seed``; ``fc`` as flax's ``Dense`` initializes (lecun normal: a normal
    truncated at ±2σ, variance 1/fan_in; zero bias)."""

    def __init__(self, n_class: int = 14, dropout: float = 0.2,
                 policy: Policy = DEFAULT_POLICY, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dropout = dropout
        self.encoder = ResNet18Encoder(policy=policy, gen=gen)
        width = ResNet18Encoder.out_channels[-1]
        std = math.sqrt(1.0 / width) / 0.87962566103423978
        weight = torch.empty(n_class, width)
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        self.fc = nn.Module()
        self.fc.weight = nn.Parameter(weight)
        self.fc.bias = nn.Parameter(torch.zeros(n_class))
        self.to(dev)
        if dev.type == "cuda":
            deterministic_cudnn()

    def forward(self, x, dropout_gen: Optional[torch.Generator] = None):
        h = global_avg_pool(self.encoder(x)[-1])
        if self.training and self.dropout > 0:
            if dropout_gen is None:
                raise ValueError("a training forward with dropout needs dropout_gen")
            h = apply_dropout(h, self.dropout, dropout_gen)
        return h.float() @ self.fc.weight.t() + self.fc.bias


# ---------------------------------------------------------------------------
# losses and the metric
# ---------------------------------------------------------------------------


def bce_with_logits(logits, labels):
    """Mean multi-label binary cross-entropy on logits (torch
    ``BCEWithLogitsLoss``), in its stable form log(1 + e^−|z|) + max(z, 0) − z·y."""
    z, y = logits.float(), labels.float()
    return torch.mean(torch.log1p(torch.exp(-z.abs())) + z.clamp(min=0.0) - z * y)


def dice_loss(probs, target, eps: float = 1e-5, group=None):
    """Soft Dice over the whole batch: over every rank's rows of ``group``
    (its three sums in one differentiable all-reduce)."""
    p, t = probs.float().reshape(-1), target.float().reshape(-1)
    sums = mesh.all_reduce_grad(torch.stack([torch.sum(p * t), torch.sum(p), torch.sum(t)]),
                                group)
    return 1.0 - (2.0 * sums[0] + eps) / (sums[1] + sums[2] + eps)


def seg_loss(probs, target, group=None):
    """Dice (over ``group``'s global batch) + BCE (this rank's rows' mean) on
    sigmoid probabilities (clipped to [1e-6, 1 − 1e-6])."""
    p = probs.float().clamp(1e-6, 1.0 - 1e-6)
    t = target.float()
    bce = -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    return dice_loss(probs, target, group=group) + bce


def pseudo_mask(volume, threshold: float = 0.5):
    """The intensity-threshold target of 3D finetuning without masks."""
    return (volume > threshold).float()


def accuracy(logits, labels):
    """Share of (sample, class) pairs whose sign of the logit is the label."""
    return ((logits > 0) == (labels > 0.5)).float().mean()


def mean_roc_auc(scores, labels) -> float:
    """Mean per-class ROC-AUC (NIH ChestX-ray14's metric, and the PCRLv2
    paper's), on the host in NumPy: Mann-Whitney U with tie-averaged
    ranks.  Classes with no positives or no negatives are skipped (AUC is
    undefined there); NaN when no class is left."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels) > 0.5
    n = scores.shape[0]
    aucs = []
    for c in range(scores.shape[1]):
        y = labels[:, c]
        n_pos = int(y.sum())
        n_neg = n - n_pos
        if n_pos == 0 or n_neg == 0:
            continue
        s = scores[:, c]
        order = np.argsort(s, kind="mergesort")
        # each run of equal scores takes its mean rank
        _, inv, counts = np.unique(s[order], return_inverse=True, return_counts=True)
        cum = np.cumsum(counts)
        ranks = np.empty(n, np.float64)
        ranks[order] = ((cum - counts + 1 + cum) / 2.0)[inv]
        aucs.append((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
    return float(np.mean(aucs)) if aucs else float("nan")


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def norm_images(images: torch.Tensor) -> torch.Tensor:
    """A raw chest batch as the classifier's input, inside the step: uint8
    becomes /255, one channel is tiled to three."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if images.shape[-1] == 1:
        images = images.tile((1, 1, 1, 3))
    return images


def images_and_labels(batch: dict):
    """(images, labels) of a raw 2D batch."""
    return norm_images(batch["image"]), batch["label"].float()


def volumes_and_masks(batch: dict):
    """(volumes, masks) of a raw 3D batch: crop 0 of each pair, channels
    last, in f32; the batch's ``mask`` or else ``pseudo_mask``."""
    volumes = batch["pair"][:, 0, ..., None].float()
    masks = batch["mask"].float() if "mask" in batch else pseudo_mask(volumes)
    return volumes, masks


def _update(state: TrainState, loss: torch.Tensor, lr) -> None:
    loss.backward()
    mesh.sync_gradients(state.model.parameters(), state.group)
    state.optimizer.step(lr)
    with torch.no_grad():
        state.step.add_(1)


def finetune_step_2d(state: TrainState, images, labels, lr,
                     dropout_gen: torch.Generator) -> dict:
    """One classifier step in place on ``state`` (the JAX
    ``make_finetune_step_2d``): BCE, backward, SGD at ``lr`` (a 0-d f32
    device tensor, or a float); returns ``loss`` and ``acc``, 0-d tensors."""
    model = state.model
    model.train()
    for p in model.parameters():
        p.grad = None
    logits = model(images, dropout_gen)
    loss = bce_with_logits(logits, labels)
    _update(state, loss, lr)
    return global_mean({"loss": loss.detach(), "acc": accuracy(logits.detach(), labels)},
                       state.group)


def finetune_step_3d(state: TrainState, volumes, masks, lr) -> dict:
    """One segmentation step of ``PCRLv23d`` in place on ``state`` (the JAX
    ``make_finetune_step_3d``): the model at ``local=True``, Dice + BCE,
    backward, SGD; returns ``loss`` and ``dice``, 0-d tensors."""
    model = state.model
    model.train()
    for p in model.parameters():
        p.grad = None
    out, _, _ = model(volumes, local=True)
    loss = seg_loss(out, masks, state.group)
    _update(state, loss, lr)
    # the Dice is already the global batch's
    return {"loss": global_mean({"loss": loss.detach()}, state.group)["loss"],
            "dice": 1.0 - dice_loss(out.detach(), masks, group=state.group)}


@torch.no_grad()
def finetune_eval_2d(model: ChestClassifier, images, labels) -> dict:
    """Eval mode (no dropout, running BN statistics), the model's state
    untouched: ``loss``, ``acc`` and the ``logits``."""
    was = model.training
    model.eval()
    try:
        logits = model(images)
    finally:
        model.train(was)
    return {"loss": bce_with_logits(logits, labels), "acc": accuracy(logits, labels),
            "logits": logits}


@torch.no_grad()
def finetune_eval_3d(model: PCRLv23d, volumes, masks, group=None) -> dict:
    """Eval mode, the model's state untouched: ``loss`` and ``dice`` (the
    Dice over ``group``'s global batch)."""
    was = model.training
    model.eval()
    try:
        out, _, _ = model(volumes, local=True)
    finally:
        model.train(was)
    return {"loss": seg_loss(out, masks, group),
            "dice": 1.0 - dice_loss(out, masks, group=group)}


def _step_fn(state: TrainState, lr: torch.Tensor, dropout_gen: torch.Generator, dim: int):
    """The step on a raw batch, as ``CapturedStep`` takes it (``fn(views,
    None) → (metrics, None)``); it holds no reference to the trainer."""

    def step(batch: dict, _next=None):
        if dim == 2:
            return finetune_step_2d(state, *images_and_labels(batch), lr, dropout_gen), None
        return finetune_step_3d(state, *volumes_and_masks(batch), lr), None
    return step


class FinetuneTrainer:
    """Load the pretrained weights, train the downstream task, save (the JAX
    ``FinetuneTrainer``), on ``device`` (default: CUDA), there as CUDA
    graphs unless ``cuda_graph=False``.  ``dim`` 2 trains a
    ``ChestClassifier(n_class)``, 3 a ``PCRLv23d``; ``weight`` is a ``.pt``
    to start from (2D: an encoder-only one or a bare torchvision
    ``state_dict``, ``fc.*`` dropped; 3D: the whole model, strictly).

    ``group``: the data-parallel process group, as ``Trainer`` takes it:
    each rank steps on its rows of the global batch ``cfg.b`` (gradients,
    BatchNorm statistics, the Dice and the metrics over the group), draws
    its dropout from its own stream, seeded from (seed, rank), and rank 0
    writes the ``.pt``."""

    def __init__(self, cfg, *, dim: int, n_class: int = 14, policy: Policy = DEFAULT_POLICY,
                 weight: Optional[str] = None, device=None, cuda_graph: bool = True,
                 group=None):
        self.device = resolve_device(device)
        self.cfg, self.dim = cfg, dim
        self.group = group
        self.rank, self.world = mesh.rank(group), mesh.world(group)
        if dim == 2:
            model = ChestClassifier(n_class, policy=policy, seed=cfg.seed, device=self.device)
        elif dim == 3:
            model = PCRLv23d(policy=policy, seed=cfg.seed, device=self.device)
        else:
            raise ValueError(f"unsupported dim {dim}")
        self.state = TrainState(model, cfg.momentum, cfg.weight_decay, group)
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            mesh.rank_seed(cfg.seed, self.rank))
        #: the epoch's learning rate, filled once per epoch
        self.lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._eager_step = _step_fn(self.state, self.lr, self.dropout_gen, dim)
        self.captured = (CapturedStep(self._eager_step, self.generators().values())
                         if cuda_graph and self.device.type == "cuda" else None)
        self.steps_run = 0
        if weight:
            self.load_pretrained(weight)
            print(f"==> finetune initialized from {weight}")
        else:
            print(SCRATCH_WARNING)
        os.makedirs(cfg.output, exist_ok=True)
        self.logger = MetricLogger(metrics_path(cfg.output, self.rank))

    def generators(self) -> dict:
        return {"dropout": self.dropout_gen} if self.dim == 2 else {}

    def load_pretrained(self, path: str) -> None:
        model = self.state.model
        if self.dim == 2:
            import_resnet18_encoder(path, model.encoder)
        else:
            import_pcrlv23d(path, model)

    def step(self, batch: dict) -> dict:
        """One step on a raw device batch → its metrics (a graph replay's
        are overwritten by the next replay): a replay after the first
        ``GRAPH_WARMUP`` steps on a CUDA device, else eager."""
        batch = {k: v for k, v in batch.items() if k in STEP_INPUTS}
        if self.captured is None or self.steps_run < GRAPH_WARMUP:
            metrics, _ = self._eager_step(batch)
        else:
            metrics, _ = self.captured(batch, None)
        self.steps_run += 1
        return metrics

    def train_epoch(self, epoch: int, batch_iter) -> dict:
        """An epoch at its cosine rate; the epoch's mean loss and metric
        (accuracy or dice) are read back once, at its end."""
        cfg = self.cfg
        lr = cosine_lr(epoch, cfg.lr, cfg.epochs)
        self.lr.fill_(lr)
        collected = []
        for batch in batch_iter:
            metrics = self.step(batch)
            collected.append(torch.stack(list(metrics.values())))  # a copy, on the device
        loss = metric = 0.0
        if collected:
            loss, metric = torch.stack(collected).double().mean(0).tolist()
        out = {"epoch": epoch, "lr": lr, "loss": loss, "metric": metric}
        self.logger.log(out)
        return out

    def evaluate(self, batch_iter, max_batches: int = 0) -> dict:
        """A pass over at most ``max_batches`` (0: all) eval batches in eval
        mode → ``eval_*`` means weighted by batch size (the last batch may be
        short); 2D adds ``eval_auc``, the mean per-class ROC-AUC of the whole
        set's logits.  Everything is gathered on the device and read back
        once; the state is left as it was.  Under more than one rank each
        evaluates its slice: the size-weighted sums are added over the ranks
        and the logits and labels gathered from them (a ragged tail is
        skipped, as ``Trainer.evaluate`` skips it)."""
        model = self.state.model
        sizes, scalars, logits, labels = [], [], [], []
        names = ()
        for i, batch in enumerate(batch_iter):
            if max_batches and i >= max_batches:
                break
            if ragged_tail(batch, self.cfg.b, self.world):
                continue
            if self.dim == 2:
                x, y = images_and_labels(batch)
                m = finetune_eval_2d(model, x, y)
                logits.append(m.pop("logits"))
                labels.append(y)
            else:
                x, y = volumes_and_masks(batch)
                m = finetune_eval_3d(model, x, y, self.group)
            names = tuple(m)
            sizes.append(x.shape[0])
            scalars.append(torch.stack(list(m.values())))
        if not sizes:
            return {}
        # per metric its size-weighted sum, then the number of samples
        weights = torch.tensor(sizes, dtype=torch.float64, device=self.device)
        totals = (torch.stack(scalars).double() * weights[:, None]).sum(0)
        parts = [mesh.all_reduce_(torch.cat([totals, weights.sum()[None]]), self.group)]
        if logits:
            parts += [mesh.all_gather_rows(torch.cat(t), self.group).double().flatten()
                      for t in (logits, labels)]
        host = torch.cat(parts).cpu().numpy()
        n = len(names)
        out = {f"eval_{k}": float(host[j] / host[n]) for j, k in enumerate(names)}
        if logits:
            scores, truth = np.split(host[n + 1:].reshape(2, int(host[n]), -1), 2)
            auc = mean_roc_auc(scores[0], truth[0])
            if np.isfinite(auc):
                out["eval_auc"] = auc
        return out

    def save(self, epoch: int) -> Optional[str]:
        """``cfg.ckpt_name(epoch)`` in the reference ``{'opt', 'state_dict',
        'optimizer', 'epoch'}`` schema: 2D a torchvision-complete ResNet-18
        (``fc`` included), 3D the whole ``PCRLv23d``; written by rank 0
        alone, None elsewhere."""
        if not mesh.is_main(self.group):
            return None
        cfg = self.cfg
        path = os.path.join(cfg.output, cfg.ckpt_name(epoch))
        model = self.state.model
        if self.dim == 2:
            state = dict(model.encoder.state_dict())
            state.update({"fc.weight": model.fc.weight, "fc.bias": model.fc.bias})
            save_reference_checkpoint(path, state, opt=vars(cfg), epoch=epoch)
        else:
            export_pcrlv23d(model, path, opt=vars(cfg), epoch=epoch)
        return path


def run_finetune(cfg, loader, *, dim: int, n_class: int = 14,
                 policy: Policy = DEFAULT_POLICY, weight: Optional[str] = None,
                 eval_loader=None, device=None, cuda_graph: bool = True,
                 group=None) -> FinetuneTrainer:
    """Load → train epochs 0..``cfg.epochs`` → save, with
    an eval pass every ``cfg.eval_every`` epochs (over ``eval_loader``'s
    epoch 0, the same batches every pass) and a ``.pt`` every
    ``cfg.save_every`` epochs before the last (the JAX ``run_finetune``);
    every loader behind ``device_prefetch``.  ``cfg.resume`` is refused.  On
    a CUDA device the run holds the GPU lock and releases it however the
    run ends; under ``group`` the first rank of each host holds it."""
    if cfg.resume:
        raise SystemExit(RESUME_REFUSED)
    device = resolve_device(device)
    lock = (chiplock.guard_warn(f"finetune d={dim} n={cfg.n}")
            if device.type == "cuda" and mesh.local_rank(group) == 0 else None)
    trainer = None
    try:
        trainer = FinetuneTrainer(cfg, dim=dim, n_class=n_class, policy=policy, weight=weight,
                                  device=device, cuda_graph=cuda_graph, group=group)
        total = cfg.epochs
        for epoch in range(total + 1):
            t0 = time.time()
            with contextlib.closing(device_prefetch(loader.epoch(epoch), device)) as batches:
                stats = trainer.train_epoch(epoch, batches)
            print(f"epoch {epoch}, total time {time.time() - t0:.2f}, loss {stats['loss']:.4f}")
            if eval_loader is not None and cfg.eval_every and epoch % cfg.eval_every == 0:
                with contextlib.closing(device_prefetch(eval_loader.epoch(0), device)) as batches:
                    ev = trainer.evaluate(batches, cfg.eval_batches)
                if ev:
                    trainer.logger.log({"epoch": epoch, **ev}, console=False)
                    print(f"eval: {ev}")
            if cfg.save_every and epoch % cfg.save_every == 0 and epoch < total:
                path = trainer.save(epoch)
                if path:
                    print(f"==> checkpoint: {path}")
        path = trainer.save(total)
        if path:
            print(f"==> saved finetuned checkpoint: {path}")
    finally:
        if trainer is not None:
            trainer.logger.close()
        if lock is not None:
            lock.release()
    return trainer
