"""Data parallelism: one process per device (port of ``pcrlv2_tpu/core/mesh.py``).

The reference trains with single-process ``nn.DataParallel`` over 4 GPUs
(``train_3d.py:54``, ``train_2d.py:75``); the JAX package with a mesh whose
``data`` axis splits the batch, the gradient ``psum`` implicit in the one
jitted step.  The port runs one process per device in a ``torch.distributed``
process group (NCCL on CUDA, gloo on the CPU).  Every rank holds the whole
model, the same parameters, BN statistics and momentum, and ``b / world``
rows of the global batch.  The step makes the result the global batch's
with three kinds of collective, all on an explicit group:

* ``all_reduce_grad``: differentiable, for the statistics that couple the
  rows of a batch (BatchNorm's sums, the whole-batch Dice); its backward
  sums the cotangents, as JAX's ``psum`` does across shards;
* ``all_reduce_`` in place: the gradients (one flat buffer), the metrics,
  the eval meters;
* ``all_gather_rows``: mixup's global batch, the eval logits.

``group`` None (world 1, no ``--multihost``) makes every helper the
identity, with no call.  ``init_distributed`` joins the group torchrun's
environment describes (the counterpart of ``jax.distributed.initialize``)
and runs one collective, so that NCCL's communicator exists before a CUDA
graph captures the step's collectives.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

#: torchrun's variables ``init_distributed`` reads
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def init_distributed(device: torch.device):
    """Join the process group the environment describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK`` picks the
    CUDA device, which ``device`` must be) and return it: NCCL on a CUDA
    device, gloo on the CPU.  One all-reduce runs before it returns."""
    missing = [k for k in ENV_VARS if k not in os.environ]
    if missing:
        raise SystemExit(f"--multihost needs torchrun's environment; {', '.join(missing)} "
                         "not set (launch with torchrun --nproc_per_node N ... --multihost)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://")
    group = dist.group.WORLD
    all_reduce_(torch.zeros(1, device=device), group)
    return group


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without one."""
    return 0 if group is None else dist.get_rank(group)


def world(group=None) -> int:
    """The number of ranks of ``group``; 1 without one."""
    return 1 if group is None else dist.get_world_size(group)


def is_main(group=None) -> bool:
    """Rank 0: the one writer of what the ranks share (``.pt``, train state)."""
    return rank(group) == 0


def local_rank(group=None) -> int:
    """This process's index among the ranks on its host (``LOCAL_RANK``);
    0 without a group."""
    return 0 if group is None else int(os.environ.get("LOCAL_RANK", rank(group)))


def batch_not_shardable(local_bsz: int, data_size: int, world: int = 1) -> bool:
    """True when a batch cannot be split over ``data_size`` devices.  The
    rule is global: each of ``world`` processes holds ``local_bsz`` rows of
    a ``local_bsz * world`` batch."""
    return data_size > 1 and (local_bsz * world) % data_size != 0


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own streams (augmentation, dropout):
    ``seed`` itself on rank 0, so a run on one rank draws what a run
    without a group draws; a stream of (``seed``, ``rank``) elsewhere."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed % 2 ** 32, rank], spawn_key=(3,))
               .generate_state(1)[0])


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place (synchronous on the current
    stream, so a CUDA graph captures it); returns it."""
    if group is not None:
        dist.all_reduce(tensor, group=group)
    return tensor


class _AllReduce(torch.autograd.Function):
    """A sum over the group whose backward sums the cotangents over the
    group (``torch.distributed.nn.functional.all_reduce``, which torch 2.13
    deprecates; JAX's ``psum``)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_grad(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` summed over ``group``, differentiably; ``tensor`` itself
    without a group."""
    return tensor if group is None else _AllReduce.apply(tensor, group)


def all_gather_rows(tensor: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``tensor`` stacked along the first axis in rank order
    (each rank holds as many rows); ``tensor`` itself without a group."""
    if group is None:
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(world(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts)


def sync_gradients(params, group) -> None:
    """Average the parameters' gradients over ``group`` in one flat-buffer
    all-reduce.  A parameter off the loss's path has no gradient on any
    rank (the ranks run one graph) and is left so."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group).div_(world(group))
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def set_stat_group(model: torch.nn.Module, group: Optional[object]) -> None:
    """Make every batch-statistics layer of ``model`` reduce over ``group``
    (flax's ``BatchNorm(axis_name=...)``); None: the local batch."""
    for m in model.modules():
        if hasattr(m, "stat_group"):
            m.stat_group = group
