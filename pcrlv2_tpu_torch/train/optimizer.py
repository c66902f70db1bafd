"""Torch-semantics SGD and the per-epoch cosine LR (port of
``pcrlv2_tpu/train/optimizer.py``; reference ``train_3d.py:48-51``,
``utils.py:101-114``).

Update, with momentum m and weight decay wd, for every parameter:
    g ← grad + wd·p;  buf ← g + m·buf;  p ← p − lr·buf
The momentum buffers start at zero, so the first step sets ``buf = g``.
``lr·buf`` and the difference are two roundings, as optax's ``−lr·trace``
then ``p + u``; ``lr`` is a 0-d f32 tensor on the device (a float is taken
too), so a captured step reads the epoch's rate where it lies.  Parameters
are updated in place; ``step(lr, skip=bad)`` reverts the update on the
device where the 0-d flag ``bad`` is true.
"""

from __future__ import annotations

import math
from typing import List

import torch

from pcrlv2_tpu_torch.core.device import on_device


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
    def step(self, lr, skip: torch.Tensor | None = None) -> None:
        """One update in place.  With ``skip`` (a 0-d bool tensor) every
        parameter and momentum buffer keeps its old value where ``skip`` is
        true: the update is computed in full and then reverted by
        ``torch.where`` on the device, exactly even when it holds NaN or Inf
        (the JAX step's ``jnp.where(bad, old, new)``), with no host read."""
        # a parameter the loss did not reach has a zero gradient (as in
        # JAX), and weight decay and momentum still move it
        with_g = [p for p in self.params if p.grad is not None]
        without = [p for p in self.params if p.grad is None]
        # g = grad + wd·p (wd·p alone where there is no gradient), in order
        g_with = iter(torch._foreach_add([p.grad for p in with_g], with_g,
                                         alpha=self.weight_decay) if with_g else ())
        g_without = iter(torch._foreach_mul(without, self.weight_decay) if without else ())
        g = [next(g_with) if p.grad is not None else next(g_without)
             for p in self.params]
        torch._foreach_add_(g, self.buffers, alpha=self.momentum)  # g + m·buf
        device = self.params[0].device
        lr = on_device(lr, torch.float32, device)
        new_p = torch._foreach_sub(self.params, torch._foreach_mul(g, lr))
        if skip is None:
            skip = torch.zeros((), dtype=torch.bool, device=device)
        for buf, p, nb, np_ in zip(self.buffers, self.params, g, new_p):
            torch.where(skip, buf, nb, out=buf)
            torch.where(skip, p, np_, out=p)


def cosine_lr(epoch: int, base_lr: float, total_epochs: int) -> float:
    """``base_lr·½(1 + cos(π·epoch/epochs))``, per epoch; ``--epochs 0``
    counts as one epoch."""
    total = max(int(total_epochs), 1)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / total))
