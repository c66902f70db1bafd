"""The 3D train step (port of ``pcrlv2_tpu/train/step.py``; reference
``train_3d.py:95-151``).

One step: the model on x1, then x2, then the 6 local views concatenated
view-major (rows ``[i·B:(i+1)·B]`` hold view i), with the BatchNorm running
statistics chained through the three calls; the 4-term loss; backward; SGD.

The SimSiam levels are an input: ``levels`` holds ``1 + 2·V`` indices in
[0, 3) — the global term's level (which also selects the deep-supervision
mask), then for each local view i the levels of its (x1, view i) and
(x2, view i) terms.  Only the selected mask level gets a gradient, so the
head backward runs once per step; all nine head forwards still run.

Finite-loss guard, as the JAX step has it (``pcrlv2_tpu/train/step.py``):
the flag ``bad`` — a non-finite loss, or a loss above ``loss_guard`` after
``guard_warmup_epochs`` (reference ``train_3d.py:140-142``) — is a 0-d bool
on the device.  The step always runs the backward pass and the SGD update,
then reverts every piece of state it touched with ``torch.where(bad, old,
new)``: parameters and momentum inside ``SGD.step(lr, skip=bad)``, where the
old values are still in hand, and the BN statistics (which the forward
updates in place) from the copy saved before it.  The step counter, a 0-d
int64 tensor, advances by ``~bad``.  Nothing in the step reads a value back
to the host, so the host can queue the next step while the device runs
this one; the metrics it returns are 0-d tensors.

Evaluation (``eval_step``, port of the JAX trainer's eval function) is the
same loss, forward only, with BatchNorm on batch statistics as in training;
the running statistics are restored afterwards, so it leaves the state as
it found it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from pcrlv2_tpu_torch.ops.resize import upsample_linear
from pcrlv2_tpu_torch.train.losses import beta_schedule, cos_loss, mse_loss
from pcrlv2_tpu_torch.train.optimizer import SGD


class TrainState:
    """Model (parameters and BN statistics), optimizer and step counter."""

    def __init__(self, model: torch.nn.Module, momentum: float = 0.9,
                 weight_decay: float = 1e-4):
        self.model = model
        self.optimizer = SGD(list(model.parameters()), momentum, weight_decay)
        device = next(model.parameters()).device
        #: updates applied, a 0-d int64 tensor on the model's device
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        #: the BN statistics as they were before the current step
        self.saved_stats = [buf.clone() for buf in model.buffers()]


def flatten_locals(locals_bv: torch.Tensor):
    """(B, V, *spatial, C) → (V·B, *spatial, C), view-major like ``torch.cat``."""
    b, v = locals_bv.shape[:2]
    return locals_bv.transpose(0, 1).reshape((v * b,) + locals_bv.shape[2:]), b, v


def loss_fn(model: torch.nn.Module, views: Dict[str, torch.Tensor],
            levels: Sequence[int], epoch: int, beta_period: float = 240.0):
    """The 4-term PCRLv2 loss → ``(total, metrics)``; metrics are detached."""
    x1, x2, gt = views["x1"], views["x2"], views["gt"]
    out1, feats1, masks1 = model(x1)
    _, feats2, _ = model(x2)
    local_flat, b, n_views = flatten_locals(views["locals"])
    _, feats_l, _ = model(local_flat, local=True)
    if len(levels) != 1 + 2 * n_views:
        raise ValueError(f"need {1 + 2 * n_views} levels, got {len(levels)}")

    loss2 = cos_loss(levels[0], feats1, feats2)
    local_loss = 0.0
    for i in range(n_views):
        feats_i = [(pro[b * i:b * (i + 1)], pre[b * i:b * (i + 1)])
                   for pro, pre in feats_l]
        l1 = cos_loss(levels[1 + 2 * i], feats1, feats_i)
        l2 = cos_loss(levels[2 + 2 * i], feats2, feats_i)
        local_loss = local_loss + l1 + l2
    local_loss = local_loss / (2 * n_views)

    loss1 = mse_loss(out1, gt)
    mask = masks1[levels[0]]
    if mask.shape != gt.shape:  # native-resolution masks: upsample the chosen one
        mask = upsample_linear(mask, gt.shape[1] // mask.shape[1])
    loss4 = beta_schedule(epoch, beta_period) * mse_loss(mask, gt)

    total = loss1 + loss2 + loss4 + local_loss
    metrics = {"loss": total, "mg_loss": loss1, "cos_loss": loss2,
               "local_loss": local_loss, "mask_loss": loss4}
    return total, {k: v.detach() for k, v in metrics.items()}


def train_step(state: TrainState, views: Dict[str, torch.Tensor],
               levels: Sequence[int], lr: float, epoch: int, *,
               loss_guard: float | None = 1000.0, guard_warmup_epochs: int = 10,
               beta_period: float = 240.0) -> Dict:
    """One training step in place on ``state``; returns the metrics and
    ``skipped`` as 0-d tensors, and ``level`` (an int from ``levels``)."""
    model = state.model
    model.train()
    buffers = list(model.buffers())
    torch._foreach_copy_(state.saved_stats, buffers)
    for p in model.parameters():
        p.grad = None
    loss, metrics = loss_fn(model, views, levels, epoch, beta_period)
    bad = ~torch.isfinite(loss.detach())
    if loss_guard is not None and epoch > guard_warmup_epochs:
        bad = bad | (loss.detach() > loss_guard)
    loss.backward()
    state.optimizer.step(lr, skip=bad)
    with torch.no_grad():
        for buf, old in zip(buffers, state.saved_stats):
            torch.where(bad, old, buf, out=buf)
        state.step.add_(~bad)
    metrics["level"] = int(levels[0])
    metrics["skipped"] = bad.float()
    return metrics


@torch.no_grad()
def eval_step(model: torch.nn.Module, views: Dict[str, torch.Tensor],
              levels: Sequence[int]) -> Dict:
    """The 4-term loss on ``views`` at epoch 0's β, forward only, BatchNorm
    on batch statistics (the JAX eval applies the model with ``train=True``
    and drops the updated statistics); every buffer of ``model`` is the
    same afterwards.  Returns the detached metrics."""
    model.train()
    saved = [buf.clone() for buf in model.buffers()]
    try:
        _, metrics = loss_fn(model, views, levels, 0)
    finally:
        for buf, old in zip(model.buffers(), saved):
            buf.copy_(old)
    return metrics
