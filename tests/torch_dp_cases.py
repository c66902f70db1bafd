"""The data-parallel cases of ``tests/test_torch_data_parallel.py``.

``run_all(rank, world, group, out)`` runs every case on rank ``rank`` of
``world`` ranks of ``group``, each rank on its rows of one global batch, and
returns what the test compares; with ``group`` None and ``world`` 1 it is
the one-rank run on the whole batch.  Run as a script it is one gloo rank
(it imports torch and the port, never JAX):

    python tests/torch_dp_cases.py RANK WORLD PORT OUT_DIR

and writes ``OUT_DIR/rank{RANK}.pt``.
"""

import os
import sys

import numpy as np
import torch

if __package__ in (None, ""):  # run as a script: the repo root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pcrlv2_tpu_torch.core import mesh  # noqa: E402
from pcrlv2_tpu_torch.core.precision import PARITY_POLICY  # noqa: E402
from pcrlv2_tpu_torch.models.layers import BatchNorm  # noqa: E402
from pcrlv2_tpu_torch.models.unet2d import PCRLv2  # noqa: E402
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d  # noqa: E402
from pcrlv2_tpu_torch.train import finetune as ft  # noqa: E402
from pcrlv2_tpu_torch.train.step import TrainState, pipelined_train_step, train_step  # noqa: E402
from pcrlv2_tpu_torch.train.trainer import TrainConfig  # noqa: E402

#: the global batch of every case
B = 4
N_CLASS = 3
LEVELS3, LEVELS2 = [0, 1, 2, 0, 1], [4, 3, 2, 1, 0]


def rows(t, rank: int, world: int):
    """This rank's rows of a global batch (rank order)."""
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def _rows(batch: dict, rank: int, world: int) -> dict:
    return {k: rows(torch.from_numpy(v), rank, world) for k, v in batch.items()}


def views3d(seed):
    rng = np.random.RandomState(seed)
    return {"x1": rng.rand(B, 16, 16, 8, 1).astype(np.float32),
            "x2": rng.rand(B, 16, 16, 8, 1).astype(np.float32),
            "gt": rng.rand(B, 16, 16, 8, 1).astype(np.float32),
            "locals": rng.rand(B, 2, 8, 8, 8, 1).astype(np.float32)}


def views2d(seed, b=2 * B):
    rng = np.random.RandomState(seed)
    return {"x1": rng.rand(b, 32, 32, 3).astype(np.float32),
            "x2": rng.rand(b, 32, 32, 3).astype(np.float32),
            "gt": rng.rand(b, 32, 32, 3).astype(np.float32),
            "locals": rng.rand(b, 2, 32, 32, 3).astype(np.float32)}


def snapshot(tstate) -> dict:
    """Parameters, BN statistics, momentum and step counter."""
    return {"state": {k: v.detach().clone() for k, v in tstate.model.state_dict().items()},
            "momentum": [b.clone() for b in tstate.optimizer.buffers],
            "step": int(tstate.step)}


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def batch_norm(rank, world, group) -> dict:
    """A training BatchNorm on a 5-D and a 4-D input: output, input
    gradient, weight and bias gradients (of this rank's rows' part of
    Σ y·cotangent), running statistics."""
    out = {}
    for name, shape in (("5d", (B, 4, 4, 2, 6)), ("4d", (B, 5, 5, 6))):
        rng = np.random.RandomState(len(shape))
        x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32))
        cot = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        bn = BatchNorm(shape[-1], PARITY_POLICY)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(rng.rand(shape[-1]).astype(np.float32) + 0.5))
            bn.bias.copy_(torch.from_numpy(rng.randn(shape[-1]).astype(np.float32)))
        mesh.set_stat_group(bn, group)
        xr = rows(x, rank, world).clone().requires_grad_()
        y = bn(xr)
        (y * rows(cot, rank, world)).sum().backward()
        out[name] = {"y": y.detach(), "dx": xr.grad, "dw": bn.weight.grad,
                     "db": bn.bias.grad, "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone()}
    return out


def pretask3d(rank, world, group) -> dict:
    """Three steps of ``PCRLv23d``: ``train_step``; ``pipelined_train_step``
    with mixup (α 0.2; λ, the permutation and the levels from a level
    generator seeded alike on every rank); a step whose NaN lies in the
    last rank's rows only, which the guard rejects."""
    tstate = TrainState(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=0), group=group)
    out = {"m1": _metrics(train_step(tstate, _rows(views3d(0), rank, world), LEVELS3,
                                     1e-3, 0))}
    out["s1"] = snapshot(tstate)
    level_gen = torch.Generator().manual_seed(7)
    m, _ = pipelined_train_step(tstate, _rows(views3d(1), rank, world), None, None, level_gen,
                                torch.tensor(1e-3), torch.tensor(0), aug_fn=None,
                                mixup_alpha=0.2, loss_guard=1000.0)
    out["m2"], out["s2"] = _metrics(m), snapshot(tstate)
    bad = views3d(2)
    bad["gt"][B - 1, 0, 0, 0, 0] = np.nan
    out["m3"] = _metrics(train_step(tstate, _rows(bad, rank, world), LEVELS3, 1e-3, 20))
    out["s3"] = snapshot(tstate)
    return out


def remat3d(rank, world, group) -> dict:
    """``pretask3d``'s first step on ``PCRLv23d(remat=True)``: the
    transitions recomputed in the backward, their BatchNorms' all-reduces
    with them."""
    tstate = TrainState(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=0, remat=True),
                        group=group)
    m = train_step(tstate, _rows(views3d(0), rank, world), LEVELS3, 1e-3, 0)
    return {"m": _metrics(m), "s": snapshot(tstate)}


def pretask2d(rank, world, group) -> dict:
    """One step of the 2D ``PCRLv2`` (no loss guard)."""
    tstate = TrainState(PCRLv2(policy=PARITY_POLICY, device="cpu", seed=0), group=group)
    m = train_step(tstate, _rows(views2d(0), rank, world), LEVELS2, 1e-3, 0, loss_guard=None)
    return {"m": _metrics(m), "s": snapshot(tstate)}


def finetune3d(rank, world, group) -> dict:
    """One segmentation step of ``PCRLv23d`` on masks (the Dice over the
    global batch)."""
    rng = np.random.RandomState(3)
    batch = {"pair": rng.rand(B, 2, 16, 16, 8).astype(np.float32),
             "mask": (rng.rand(B, 16, 16, 8, 1) > 0.7).astype(np.float32)}
    tstate = TrainState(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=1), group=group)
    m = ft.finetune_step_3d(tstate, *ft.volumes_and_masks(_rows(batch, rank, world)), 0.1)
    return {"m": _metrics(m), "s": snapshot(tstate)}


def chest_batch(seed, b=B, size=32):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (b, size, size, 1)).astype(np.uint8),
            "label": rng.randint(0, 2, (b, N_CLASS)).astype(np.float32)}


def finetune2d(rank, world, group) -> dict:
    """One ``ChestClassifier`` step with dropout 0.2.  Each rank's dropout
    generator is the one-rank run's, advanced past the draws of the ranks
    before it (B/world × 512 uniforms each), so the ranks together draw the
    one-rank run's mask."""
    model = ft.ChestClassifier(N_CLASS, 0.2, PARITY_POLICY, seed=0, device="cpu")
    tstate = TrainState(model, group=group)
    gen = torch.Generator().manual_seed(5)
    if rank:
        torch.rand((rank * B // world, 512), generator=gen)
    batch = _rows(chest_batch(4), rank, world)
    m = ft.finetune_step_2d(tstate, *ft.images_and_labels(batch), 0.1, gen)
    return {"m": _metrics(m), "s": snapshot(tstate)}


def finetune_eval(rank, world, group, out_dir) -> dict:
    """``FinetuneTrainer.evaluate`` of a 2D classifier over two global
    batches: the means and ``eval_auc``."""
    cfg = TrainConfig(b=B, epochs=0, output=os.path.join(out_dir, f"eval{rank}"), seed=0,
                      phase="finetune")
    trainer = ft.FinetuneTrainer(cfg, dim=2, n_class=N_CLASS, policy=PARITY_POLICY,
                                 device="cpu", group=group)
    batches = [_rows(chest_batch(s), rank, world) for s in (5, 6)]
    ev = trainer.evaluate(batches)
    trainer.logger.close()
    return ev


def run_all(rank: int, world: int, group, out_dir: str) -> dict:
    """Every case; ``remat3d`` only in a group (it is held to the group's
    own plain step)."""
    out = {"bn": batch_norm(rank, world, group), "pretask3d": pretask3d(rank, world, group),
           "pretask2d": pretask2d(rank, world, group),
           "finetune3d": finetune3d(rank, world, group),
           "finetune2d": finetune2d(rank, world, group),
           "eval": finetune_eval(rank, world, group, out_dir)}
    if group is not None:
        out["remat3d"] = remat3d(rank, world, group)
    return out


if __name__ == "__main__":
    rank_, world_, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(rank_),
                      WORLD_SIZE=str(world_), LOCAL_RANK=str(rank_))
    group_ = mesh.init_distributed(torch.device("cpu"))
    result = run_all(rank_, world_, group_, out)
    result["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                               ("jax", "jaxlib", "flax", "optax", "pcrlv2_tpu"))
    torch.save(result, os.path.join(out, f"rank{rank_}.pt"))
    torch.distributed.destroy_process_group()
