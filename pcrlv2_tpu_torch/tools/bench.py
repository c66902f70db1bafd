"""Throughput of pretraining on one GPU: the port's counterpart of the JAX
package's ``bench.py``.

    python -m pcrlv2_tpu_torch.tools.bench
    BENCH_DIM=2 python -m pcrlv2_tpu_torch.tools.bench

The whole train step at the reference's operating point (``run3d.sh``:
b = 32, 64×64×32 crop pairs and six 16³ local crops), ``PCRLv23d`` under
``DEFAULT_POLICY`` (bf16 compute, f32 parameters: the JAX ``PCRLv23d()``'s
policy and the port's ``--amp``), on a synthetic batch on the device.  The
loop is the trainer's own (``Trainer.step``): the step plus the next
batch's augmentation (``pipelined_train_step``) as CUDA graphs
(``CapturedStep``, captured after ``GRAPH_WARMUP`` eager steps).
``BENCH_DIM=2`` times the 2D chest step instead, as ``bench.py:60-105``
does: ``PCRLv2`` on 224² global and 96² local views of
``make_chest_aug_fn``, from ``synthetic_chest_batch`` (float RGB on a 512²
canvas) at 2 × ``BENCH_BATCH`` images (``run2d.sh``'s b = 64 by default);
the value is images/s.  ``BENCH_WARMUP`` steps
(at least ``GRAPH_WARMUP`` + 1, so the capture is among them), then
``BENCH_TRIALS`` trials of ``BENCH_STEPS`` steps, each closed by
``torch.cuda.synchronize()``; the value is the median trial's volumes/s.

Environment (names and defaults of ``bench.py``): ``BENCH_BATCH`` (32),
``BENCH_WARMUP`` (3), ``BENCH_STEPS`` (20), ``BENCH_TRIALS`` (3),
``BENCH_LAZY_MASKS=1`` (``upsample_masks=False``), ``BENCH_DIM`` (3 or 2),
``BENCH_REMAT=1`` (``PCRLv23d(remat=True)``: each transition recomputed in
the backward; the 2D model has no such option and raises).  ``BENCH_PRNG``
selects a ``jax.random`` key implementation, which has no counterpart
here, and raises.

Prints one JSON line: ``metric``, ``value``, ``unit``, ``trials`` and,
when the trials spread by more than 10 %, ``spread_warning`` (the JAX
bench's keys), plus ``device`` (the card's name and power limit, as
``nvidia-smi`` gives them), ``peak_memory_gib`` (``max_memory_allocated``
over the run, the graphs' pool included), ``batch``, ``compute_dtype`` and
``remat``.
There is no ``vs_baseline``: the JAX bench's denominator is an estimate
for the reference's 2021 GPUs, neither measured nor this card's.

It holds the GPU lock (``utils/chiplock.py``) and refuses to run while
another process holds it.  Without CUDA it raises, unless ``main(device=
"cpu")`` or ``run(..., device="cpu")`` is called (a run of the same loop,
eager, with no device number).  ``run`` takes the batch and the policy, so
other callers time other policies and sizes through the same loop.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import tempfile
import time

import torch

from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from pcrlv2_tpu_torch.data.augment2d import make_chest_aug_fn
from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
from pcrlv2_tpu_torch.data.pipeline import synthetic_chest_batch, synthetic_luna_batch
from pcrlv2_tpu_torch.models.unet2d import PCRLv2
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train.optimizer import cosine_lr
from pcrlv2_tpu_torch.train.trainer import GRAPH_WARMUP, TrainConfig, Trainer
from pcrlv2_tpu_torch.utils import chiplock

#: (metric, unit) of each BENCH_DIM, as bench.py names them
METRICS = {3: ("3d_pretrain_volumes_per_sec_per_chip", "volumes/sec/chip"),
           2: ("2d_pretrain_imgs_per_sec_per_chip", "imgs/sec/chip")}


def device_label(device: torch.device) -> str:
    """``"<name>, <power limit>"`` of a CUDA device, as ``nvidia-smi`` gives
    them (its name alone if ``nvidia-smi`` cannot be read); ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(index)],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def run(batch: dict, policy: Policy, *, warmup: int = 3, steps: int = 20, trials: int = 3,
        device=None, upsample_masks: bool = True, remat: bool = False) -> dict:
    """Time the trainer's step (``Trainer.step``: the pipelined step, on CUDA
    graphs after ``GRAPH_WARMUP`` eager steps) on ``batch`` under
    ``policy``, at epoch 0's learning rate: raw LUNA crops (``pair`` (B, 2,
    X, Y, Z), ``locals`` (B, V, x, y, z)) train ``PCRLv23d``, a chest batch
    (``image`` (B, canvas, canvas, C)) ``PCRLv2``, each through its
    pipeline's augmentation (``remat``: ``PCRLv23d(remat=True)``).  Prints
    the JSON line and returns it as a dict.  The trainer's ``metrics.jsonl`` goes to a
    temporary directory."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    dim = 2 if "image" in batch else 3
    size = next(iter(batch.values())).shape[0]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if dim == 2:
        if remat:
            raise ValueError("the 2D PCRLv2 has no activation checkpointing")
        model = PCRLv2(policy=policy, upsample_masks=upsample_masks, seed=0, device=dev)
        aug_fn = make_chest_aug_fn()
    else:
        model = PCRLv23d(policy=policy, upsample_masks=upsample_masks, seed=0, device=dev,
                         remat=remat)
        aug_fn = make_luna_aug_fn()
    with tempfile.TemporaryDirectory() as out:
        cfg = TrainConfig(b=size, epochs=0, output=out, seed=0,
                          amp=policy.compute_dtype == torch.bfloat16)
        trainer = Trainer(model, cfg, aug_fn, dev)
        try:
            trainer.lr.fill_(cosine_lr(0, cfg.lr, cfg.epochs))
            # on the card the capture falls in the warm-up
            warm = max(warmup, GRAPH_WARMUP + 1) if cuda else warmup
            rates, metrics = _timed(trainer, batch, warm, steps, trials)
        finally:
            trainer.logger.close()
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"the benchmarked step's loss is {loss}")
    value = sorted(rates)[len(rates) // 2]  # the median of an odd count, as bench.py
    metric, unit = METRICS[dim]
    out = {"metric": metric, "value": round(value, 3), "unit": unit,
           "trials": [round(r, 3) for r in sorted(rates)]}
    spread = (max(rates) - min(rates)) / value
    if spread > 0.10:
        out["spread_warning"] = (f"trial spread {spread:.1%} > 10% — measurement "
                                 "perturbed, rerun")
    out.update(device=device_label(dev),
               peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None,
               batch=size, compute_dtype=str(policy.compute_dtype).removeprefix("torch."),
               remat=remat)
    print(json.dumps(out), flush=True)
    return out


def _timed(trainer: Trainer, batch: dict, warmup: int, steps: int, trials: int):
    """``warmup`` steps, then ``trials`` timed runs of ``steps`` steps, each
    step augmenting ``batch`` for the next; returns (volumes or images a
    second of each trial, the last step's metrics)."""
    views = trainer.aug_fn(trainer.aug_gen, batch)
    cuda = trainer.device.type == "cuda"
    size = next(iter(batch.values())).shape[0]

    def sync():
        if cuda:
            torch.cuda.synchronize(trainer.device)

    for _ in range(warmup):
        metrics, views = trainer.step(views, batch)
    sync()
    rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics, views = trainer.step(views, batch)
        sync()
        rates.append(size * steps / (time.perf_counter() - t0))
    return rates, metrics


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def main(device=None) -> dict:
    """The bench as ``bench.py`` runs it, from the ``BENCH_*`` variables."""
    dim = _env_int("BENCH_DIM", 3)
    if dim not in METRICS:
        raise SystemExit(f"BENCH_DIM={dim}: expected 3 or 2")
    remat = os.environ.get("BENCH_REMAT", "0") == "1"
    if remat and dim == 2:
        raise SystemExit("BENCH_REMAT=1 with BENCH_DIM=2: the 2D PCRLv2 has no activation "
                         "checkpointing (bench.py applies it to the 3D model only)")
    if os.environ.get("BENCH_PRNG"):
        raise SystemExit("BENCH_PRNG selects a jax.random key implementation; the port "
                         "draws from torch.Generator and has no counterpart")
    dev = resolve_device(device)
    kwargs = dict(warmup=_env_int("BENCH_WARMUP", 3), steps=_env_int("BENCH_STEPS", 20),
                  trials=max(1, _env_int("BENCH_TRIALS", 3)), device=dev,
                  upsample_masks=os.environ.get("BENCH_LAZY_MASKS", "0") != "1", remat=remat)
    size = _env_int("BENCH_BATCH", 32)
    # bench.py times the 2D step at twice BENCH_BATCH (run2d.sh's b = 64)
    batch = synthetic_chest_batch(2 * size) if dim == 2 else synthetic_luna_batch(size)
    if dev.type != "cuda":
        return run(batch, DEFAULT_POLICY, **kwargs)
    with chiplock.guard_exclusive("pcrlv2_tpu_torch.tools.bench"):
        return run(batch, DEFAULT_POLICY, **kwargs)


if __name__ == "__main__":
    main()
