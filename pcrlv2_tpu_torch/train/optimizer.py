"""Torch-semantics SGD and the per-epoch cosine LR (port of
``pcrlv2_tpu/train/optimizer.py``; reference ``train_3d.py:48-51``,
``utils.py:101-114``).

Update, with momentum m and weight decay wd, for every parameter:
    g ← grad + wd·p;  buf ← g + m·buf;  p ← p + (−lr)·buf
The momentum buffers start at zero, so the first step sets ``buf = g``.
Parameters are updated in place.
"""

from __future__ import annotations

import math
from typing import List

import torch


class SGD:
    """Momentum buffers for ``params`` and the update above."""

    def __init__(self, params: List[torch.Tensor], momentum: float = 0.9,
                 weight_decay: float = 1e-4):
        self.params = list(params)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.buffers = [torch.zeros_like(p, dtype=torch.float32)
                        for p in self.params]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        for p, buf in zip(self.params, self.buffers):
            # a parameter the loss did not reach has a zero gradient (as in
            # JAX), and weight decay and momentum still move it
            g = self.weight_decay * p.float()
            if p.grad is not None:
                g = p.grad.float() + g
            buf.copy_(g + self.momentum * buf)
            p.copy_(p + (-lr) * buf)


def cosine_lr(epoch: int, base_lr: float, total_epochs: int) -> float:
    """``base_lr·½(1 + cos(π·epoch/epochs))``, per epoch; ``--epochs 0``
    counts as one epoch."""
    total = max(int(total_epochs), 1)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / total))
