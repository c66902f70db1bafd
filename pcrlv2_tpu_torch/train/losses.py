"""Loss terms of the PCRLv2 objective (port of ``pcrlv2_tpu/train/losses.py``;
reference ``train_3d.py:86-92,119-138``).

The SimSiam level is an argument: the train step takes the sampled level
indices as input (the trainer draws them), so one set of levels gives the
same loss in both packages.  A level is a 0-d int64 tensor on the device
(an int is taken too): the loss of every level is computed and the drawn one
selected by index, so the step launches the same kernels whatever the draw
(what a CUDA graph needs; the JAX package's ``lax.switch`` on a traced index
runs the whole decoder backward too).  The unselected levels get a gradient
of exactly zero: indexing, not a 0/1 product (0·inf would be NaN).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity in f32, denominator clamped at ``eps``."""
    a, b = a.float(), b.float()
    dot = (a * b).sum(dim=1)
    return dot / torch.clamp(a.norm(dim=1) * b.norm(dim=1), min=eps)


def _pair_loss(pair1, pair2) -> torch.Tensor:
    """-½·[cos(pre₁, sg(pro₂)) + cos(pre₂, sg(pro₁))], means over the batch."""
    pro1, pre1 = pair1
    pro2, pre2 = pair2
    l1 = cosine_similarity(pre1, pro2.detach()).mean()
    l2 = cosine_similarity(pre2, pro1.detach()).mean()
    return -(l1 + l2) * 0.5


def select(values: torch.Tensor, index) -> torch.Tensor:
    """``values[index]`` along the first axis, ``index`` a 0-d int64 tensor
    on ``values``' device (or an int): an ``index_select``, which reads
    nothing back to the host; the gradient of every other entry is 0."""
    index = torch.as_tensor(index, device=values.device)
    return values.index_select(0, index.reshape(1)).squeeze(0)


def cos_loss(level, outputs1: Sequence[Tuple[torch.Tensor, torch.Tensor]],
             outputs2: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """SimSiam cosine loss at decoder ``level``: every level's loss, the
    drawn one selected (nonzero gradients flow only there)."""
    return select(torch.stack([_pair_loss(a, b) for a, b in zip(outputs1, outputs2)]),
                  level)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean-squared error in f32."""
    diff = pred.float() - target.float()
    return (diff * diff).mean()


def beta_schedule(epoch, period: float = 240.0) -> torch.Tensor:
    """β = ½(1 + cos(π·epoch/240)) in f32 (reference ``train_3d.py:136``);
    ``epoch`` a 0-d tensor (β computed where it lies) or an int."""
    return 0.5 * (1.0 + torch.cos(torch.as_tensor(math.pi * epoch / period,
                                                  dtype=torch.float32)))
