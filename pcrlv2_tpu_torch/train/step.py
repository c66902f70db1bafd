"""The train step of both pipelines (port of ``pcrlv2_tpu/train/step.py``;
reference ``train_3d.py:95-151``, ``train_2d.py:120-172``).

One step: the model on x1, then x2, then the 6 local views concatenated
view-major (rows ``[i·B:(i+1)·B]`` hold view i), with the BatchNorm running
statistics chained through the three calls; the 4-term loss; backward; SGD.
The model says which pipeline: ``model.dim`` (3: ``PCRLv23d``, which returns
``(out, feats, masks)``; 2: ``PCRLv2``, ``(feats, out, masks)``) and
``model.n_levels`` (its decoder stages: 3 or 5).

The SimSiam levels are an input: ``levels``, a 1-D int64 tensor on the
device, holds ``1 + 2·V`` indices in [0, ``n_levels``) — the global term's
level (which also selects the deep-supervision mask), then for each local
view i the levels of its (x1, view i) and (x2, view i) terms.  Every level's loss is
computed and the drawn one selected by index (``losses.select``), so a step
launches the same kernels whatever the draw: every decoder stage runs its
backward (the unselected ones on a gradient of exactly zero), and so do the
three mask heads of x1.  ``lr`` (0-d f32) and ``epoch`` (0-d int64, from
which β and the guard's warm-up flag are computed) are device tensors too.
``train_step`` takes lists, floats and ints as well and copies them over.

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

Input mixup (``mixup_alpha``, the JAX step's ``mixup_alpha``; the
reference defines ``mixup_data`` but never calls it): ``mix`` = (λ, perm),
a 0-d f32 λ ≥ 0.5 and a permutation of the batch, both on the device;
x1, x2 and gt (not the locals) become ``λ·t + (1 − λ)·t[perm]`` before the
forwards.  ``draw_mixup`` draws them.

Data parallelism (``TrainState.group``, ``core/mesh.py``): each rank runs
the step on its rows of the global batch.  The BatchNorms reduce their
statistics over the group, the gradients are averaged over it in one
flat-buffer all-reduce after backward, and the metrics are averaged before
the guard reads the loss, so every rank takes the same branch; mixup
permutes the global batch (``mix_rows``).  The levels and λ come from the
level generator, seeded alike on every rank.  The collectives are
synchronous on the current stream, so a CUDA graph captures them.

``pipelined_train_step`` is the port of ``make_pipelined_train_step``: it
draws the step's mixup and levels on the device, runs the step and then
the NEXT batch's augmentation, the JAX package's one program per step; the
trainer captures it as a CUDA graph.

Evaluation (``eval_step``, port of the JAX trainer's eval function) is the
same loss, forward only, with BatchNorm on batch statistics as in training;
the running statistics are restored afterwards, so it leaves the state as
it found it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from pcrlv2_tpu_torch.core import mesh
from pcrlv2_tpu_torch.core.device import on_device
from pcrlv2_tpu_torch.ops.resize import upsample_linear
from pcrlv2_tpu_torch.train.losses import beta_schedule, cos_loss, mse_loss, select
from pcrlv2_tpu_torch.train.optimizer import SGD

#: the loss guard of each pipeline (``pcrlv2_tpu/train/trainer.py:82``): the
#: reference's 2D loop skips no step (``train_2d.py:120-172``)
LOSS_GUARD = {3: 1000.0, 2: None}


class TrainState:
    """Model (parameters and BN statistics), optimizer and step counter,
    and the data-parallel process group they are replicated over (None:
    one rank); the model's BatchNorms take their statistics over it."""

    def __init__(self, model: torch.nn.Module, momentum: float = 0.9,
                 weight_decay: float = 1e-4, group=None):
        self.model = model
        self.group = group
        mesh.set_stat_group(model, group)
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


def forward(model: torch.nn.Module, x: torch.Tensor, local: bool = False):
    """``model(x, local)`` as ``(out, feats, masks)`` whichever the pipeline."""
    outs = model(x, local=local)
    if model.dim == 2:
        feats, out, masks = outs
        return out, feats, masks
    return outs


def mix_rows(t: torch.Tensor, lam: torch.Tensor, perm: torch.Tensor, group=None):
    """This rank's rows of ``λ·t + (1 − λ)·t[perm]`` over the global batch
    (every rank's rows of ``t`` in rank order; ``perm`` permutes them)."""
    b = t.shape[0]
    rows = perm if group is None else perm.narrow(0, mesh.rank(group) * b, b)
    return lam * t + (1.0 - lam) * mesh.all_gather_rows(t, group).index_select(0, rows)


def loss_fn(model: torch.nn.Module, views: Dict[str, torch.Tensor],
            levels, epoch, beta_period: float = 240.0,
            mix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, group=None):
    """The 4-term PCRLv2 loss → ``(total, metrics)``; metrics are detached.
    ``levels`` and ``epoch`` as ``train_step`` takes them; ``mix`` = (λ,
    perm) mixes x1, x2 and gt first, over the global batch of ``group``'s
    ranks.  Under a group the loss is this rank's rows' (their mean), on the
    global batch's BatchNorm statistics."""
    x1, x2, gt = views["x1"], views["x2"], views["gt"]
    levels = on_device(levels, torch.int64, x1.device)
    epoch = on_device(epoch, torch.int64, x1.device)
    if mix is not None:
        x1, x2, gt = (mix_rows(t, *mix, group) for t in (x1, x2, gt))
    out1, feats1, masks1 = forward(model, x1)
    _, feats2, _ = forward(model, x2)
    local_flat, b, n_views = flatten_locals(views["locals"])
    _, feats_l, _ = forward(model, local_flat, local=True)
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
    # native-resolution masks are upsampled to gt's size first
    mask_mse = torch.stack([
        mse_loss(m if m.shape == gt.shape else upsample_linear(m, gt.shape[1] // m.shape[1]),
                 gt) for m in masks1])
    loss4 = beta_schedule(epoch, beta_period) * select(mask_mse, levels[0])

    total = loss1 + loss2 + loss4 + local_loss
    metrics = {"loss": total, "mg_loss": loss1, "cos_loss": loss2,
               "local_loss": local_loss, "mask_loss": loss4}
    return total, {k: v.detach() for k, v in metrics.items()}


def train_step(state: TrainState, views: Dict[str, torch.Tensor],
               levels, lr, epoch, *,
               loss_guard: float | None = 1000.0, guard_warmup_epochs: int = 10,
               beta_period: float = 240.0,
               mix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Dict:
    """One training step in place on ``state``; returns the metrics,
    ``skipped`` and ``level`` (``levels[0]``) as 0-d tensors.  ``levels``
    (1-D int64), ``lr`` (0-d f32) and ``epoch`` (0-d int64) are device
    tensors, or a list, a float and an int, copied over first; ``mix`` as
    ``loss_fn`` takes it."""
    model = state.model
    device = state.step.device
    levels = on_device(levels, torch.int64, device)
    lr = on_device(lr, torch.float32, device)
    epoch = on_device(epoch, torch.int64, device)
    model.train()
    buffers = list(model.buffers())
    torch._foreach_copy_(state.saved_stats, buffers)
    for p in model.parameters():
        p.grad = None
    loss, metrics = loss_fn(model, views, levels, epoch, beta_period, mix, state.group)
    loss.backward()
    mesh.sync_gradients(model.parameters(), state.group)
    # the global batch's loss decides for every rank alike
    metrics = global_mean(metrics, state.group)
    bad = ~torch.isfinite(metrics["loss"])
    if loss_guard is not None:
        bad = bad | ((metrics["loss"] > loss_guard) & (epoch > guard_warmup_epochs))
    state.optimizer.step(lr, skip=bad)
    with torch.no_grad():
        for buf, old in zip(buffers, state.saved_stats):
            torch.where(bad, old, buf, out=buf)
        state.step.add_(~bad)
    metrics["level"] = levels[0]
    metrics["skipped"] = bad.float()
    return metrics


def global_mean(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The 0-d ``metrics`` averaged over ``group``'s ranks in one
    all-reduce (each rank's are means over as many rows); as they are
    without a group."""
    if group is None:
        return metrics
    flat = mesh.all_reduce_(torch.stack(list(metrics.values())), group) / mesh.world(group)
    return dict(zip(metrics, flat.unbind()))


def draw_levels(gen: torch.Generator, n_views: int, n_levels: int = 3) -> torch.Tensor:
    """The 1 + 2·V SimSiam levels of one step in [0, ``n_levels``), drawn on
    ``gen``'s device."""
    return torch.randint(0, n_levels, (1 + 2 * n_views,), generator=gen,
                         device=gen.device)


def draw_mixup(gen: torch.Generator, alpha: float, batch: int):
    """(λ, perm) of one step on ``gen``'s device: λ ~ Beta(α, α) folded to
    max(λ, 1 − λ), perm the ``argsort`` of uniform keys.  λ = G₁/(G₁ + G₂)
    of two Gamma(α) draws, taken in log space as JAX's ``random.beta`` is:
    at α = 0.2 an f32 Gamma(α) draw falls below 1e-8 about 3 % of the time
    and can reach the smallest normal float, where the ratio loses its
    precision, so each is drawn as log G(α + 1) + log(U)/α (U ∈ (0, 1]) and
    λ is the sigmoid of their difference, finite for any draw."""
    dev = gen.device
    shape = torch.full((2,), alpha + 1.0, device=dev)
    log_g = (torch.log(torch._standard_gamma(shape, generator=gen))
             + torch.log1p(-torch.rand(2, generator=gen, device=dev)) / alpha)
    lam = torch.sigmoid(log_g[0] - log_g[1])
    perm = torch.rand(batch, generator=gen, device=dev).argsort()
    return torch.maximum(lam, 1.0 - lam), perm


def pipelined_train_step(state: TrainState, views: Dict[str, torch.Tensor],
                         raw_next: Optional[Dict[str, torch.Tensor]],
                         aug_gen: torch.Generator, level_gen: torch.Generator,
                         lr, epoch, *, aug_fn: Callable,
                         mixup_alpha: Optional[float] = None, **step_kwargs):
    """The step and the NEXT batch's augmentation in one function (port of
    ``make_pipelined_train_step``, ``pcrlv2_tpu/train/step.py:245-285``):
    draws the mixup (with ``mixup_alpha``) and the levels on ``level_gen``,
    runs ``train_step`` on ``views``, then ``aug_fn(aug_gen, raw_next)``.
    Returns ``(metrics, next_views)``.

    ``raw_next=None`` is the last step of an epoch: the step alone, with no
    augmentation draws (the JAX trainer feeds the last batch as its own
    dummy, which its stateless keys allow; the port's generators are not
    stateless), so a pipelined run draws what the sequential ``aug_fn`` +
    ``train_step`` loop draws, across epochs and resumes; ``next_views`` is
    then None.  The two generators keep the draws of each in order."""
    mix = (None if mixup_alpha is None else draw_mixup(
        level_gen, mixup_alpha, views["x1"].shape[0] * mesh.world(state.group)))
    levels = draw_levels(level_gen, views["locals"].shape[1], state.model.n_levels)
    metrics = train_step(state, views, levels, lr, epoch, mix=mix, **step_kwargs)
    next_views = None if raw_next is None else aug_fn(aug_gen, raw_next)
    return metrics, next_views


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
