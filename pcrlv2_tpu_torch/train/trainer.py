"""Epoch loop of pretraining, 3D and 2D (port of ``pcrlv2_tpu/train/trainer.py``;
reference ``train_3d.py:42-83``, ``train_2d.py:61-107``): cosine LR per epoch, every loader behind
``device_prefetch``, one pipelined step per batch (the step and the next
batch's augmentation, ``pipelined_train_step``), meters every ``log_every``
steps, a held-out evaluation every ``eval_every`` epochs, reference-schema
``.pt`` checkpoints at ``epoch % 100 == 0`` or ``epoch == 240`` named
``{model}_{n}_{phase}_{ratio}_{epoch}.pt`` (the 2D model's encoder only, as
the reference saves it), and the train state at those
epochs and every ``save_every`` epochs (``<output>/train_state``), from
which ``resume`` continues; ``profile_dir`` wraps the epochs in a
``torch.profiler`` trace.

On a CUDA device the pipelined step runs as CUDA graphs (``CapturedStep``),
the port's counterpart of the JAX trainer's one jitted program a step: after
``GRAPH_WARMUP`` eager steps, one graph launch a step plus the raw batch's
copy into the graph's buffers; ``cuda_graph=False`` keeps the eager loop.
On the CPU the same function runs eagerly.

Randomness comes from two generators on the device, seeded from ``seed``:
one for the augmentation, one for the SimSiam levels; both are part of the
train state.  Evaluation draws its levels from a generator seeded by
(seed, batch index), so it is the same on every pass.  The 2D pipeline
evaluates on the augmentation's views (the reference's chest eval loader
aliases the train pipeline, ``data.py:58-59``), drawn on a generator seeded
by (seed, batch index) too (``eval_aug_seed``).
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pcrlv2_tpu_torch.core import mesh
from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.data.pipeline import CUDA_CALLS, device_prefetch
from pcrlv2_tpu_torch.ops import _build
from pcrlv2_tpu_torch.train.checkpoint import (export_pcrlv23d, export_resnet18_encoder,
                                               import_resnet18_encoder, load_train_state,
                                               save_train_state)
from pcrlv2_tpu_torch.train.optimizer import cosine_lr
from pcrlv2_tpu_torch.train.step import (LOSS_GUARD, TrainState, eval_step,
                                         pipelined_train_step)
from pcrlv2_tpu_torch.utils import chiplock
from pcrlv2_tpu_torch.utils.meters import AverageMeter, MetricLogger, metrics_path

#: eager steps before the first capture: the first step builds and binds the
#: kernels and starts cuBLAS and autograd's device thread, none of which a
#: capture can do
GRAPH_WARMUP = 1
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
    profile_dir: Optional[str] = None  # a torch.profiler trace of the run goes here
    mixup: Optional[float] = None  # input-mixup α (the JAX step's mixup_alpha)
    encoder_weights: Optional[str] = None  # a ResNet-18 .pt the 2D encoder starts from

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


def eval_levels(seed: int, index: int, n_views: int, n_levels: int = 3) -> list:
    """The 1 + 2·V levels in [0, ``n_levels``) of eval batch ``index``, from a
    generator seeded by (seed, index)."""
    key = int(np.random.SeedSequence([seed % 2 ** 32, index]).generate_state(1)[0])
    gen = torch.Generator().manual_seed(key)
    return torch.randint(0, n_levels, (1 + 2 * n_views,), generator=gen).tolist()


def eval_aug_seed(seed: int, index: int) -> int:
    """The seed of the augmentation that makes 2D eval batch ``index``'s
    views: a stream of (seed, index) apart from the eval levels'."""
    return int(np.random.SeedSequence([seed % 2 ** 32, index], spawn_key=(2,))
               .generate_state(1)[0])


def ragged_tail(raw: dict, global_batch: int, world: int) -> bool:
    """Whether to skip ``raw``, an eval batch, under ``world`` ranks: the JAX
    trainer skips, with this warning, a tail batch its data axis cannot
    split under multihost sharding (``pcrlv2_tpu/train/trainer.py:209-224``);
    each of the port's ranks holds its own rows, and it skips a tail
    shorter than a rank's share of ``global_batch``, so that the ranks'
    batches stay rows of one global batch of ``global_batch``."""
    bsz = int(next(iter(raw.values())).shape[0])
    if world == 1 or bsz * world == global_batch:
        return False
    print(f"WARNING: eval tail batch of {bsz} samples skipped (short of the "
          f"{global_batch // world} rows each of the {world} data-parallel ranks takes)")
    return True


def level_seed(seed: int) -> int:
    """The seed of the training levels' generator: a stream of ``seed``
    apart from the augmentation's and the eval levels'."""
    return int(np.random.SeedSequence(seed % 2 ** 32, spawn_key=(1,)).generate_state(1)[0])


def _signature(tensors: dict) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(tensors.items()))


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    batch: Optional[dict]  # the raw batch's buffers (None: the step-only graph)
    metrics: dict
    next_views: Optional[dict]
    launches: dict  # kernel launches of one replay


class CapturedStep:
    """``step_fn(views, batch) → (metrics, next_views)`` as CUDA graphs, one
    per shapes and dtypes of its inputs, each captured at its first call and
    replayed at every call.

    A graph reads its views and raw batch from buffers of its own, filled by
    a copy before each replay (none for views that are its own last output);
    ``step_fn`` reads anything else it needs (the epoch's ``lr`` and
    ``epoch``) from tensors its owner fills.  Where the next views have the
    views' shapes, the graph copies them over its input views at its end, so
    the next replay finds them there.  ``batch=None`` (an epoch's last step)
    is the step-only graph.

    All graphs share one memory pool: they never run at once, and what a
    replay leaves for later lies outside the pool (parameters, statistics,
    momentum, step counter, the input buffers) or is read before the next
    replay (the metrics, and the next views of a graph whose output shapes
    differ from its inputs').  ``generators`` are registered with each graph,
    so a replay advances them as the eager step does.  A capture holds
    ``CUDA_CALLS``, so ``device_prefetch``'s worker makes no CUDA call
    meanwhile, runs in ``thread_local`` mode (another thread's CUDA call
    does not end it) and with the garbage collector off (collected first).  A graph
    keeps the kernel launches its capture made and adds them to
    ``_build.launches`` at every replay.  A failed capture or replay raises."""

    def __init__(self, step_fn, generators):
        self.step_fn = step_fn
        self.generators = list(generators)
        self.pool = None
        self.graphs: dict = {}
        self.views: dict = {}  # views' signature → the graphs' input views
        #: seconds each capture took, by signature
        self.capture_s: dict = {}

    def __call__(self, views: dict, batch: Optional[dict]):
        vkey = _signature(views)
        key = (vkey, None if batch is None else _signature(batch))
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(views, batch, key)
        inputs = self.views[vkey]
        if views is not inputs:
            for k, v in views.items():
                inputs[k].copy_(v)
        if batch is not None:
            for k, v in batch.items():
                entry.batch[k].copy_(v)
        entry.graph.replay()
        _build.launches.update(entry.launches)
        return entry.metrics, entry.next_views

    def _capture(self, views: dict, batch: Optional[dict], key) -> _Graph:
        t0 = time.perf_counter()
        inputs = self.views.get(key[0])
        if inputs is None:
            inputs = self.views[key[0]] = {k: torch.empty_like(v) for k, v in views.items()}
        batch_in = None if batch is None else {k: torch.empty_like(v) for k, v in batch.items()}
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # destroying a graph (a dead trainer's, collected) is a call a capture
        # forbids: collect before, and keep the collector off until it ends
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with CUDA_CALLS, _build.capturing() as launches, torch.cuda.graph(
                    graph, pool=self.pool, capture_error_mode="thread_local"):
                metrics, next_views = self.step_fn(inputs, batch_in)
                if next_views is not None and _signature(next_views) == key[0]:
                    for k, v in next_views.items():
                        inputs[k].copy_(v)
                    next_views = inputs
        finally:
            if collecting:
                gc.enable()
        self.capture_s[key] = time.perf_counter() - t0
        return _Graph(graph, batch_in, metrics, next_views, dict(launches))


def _step_fn(state: TrainState, aug_gen, level_gen, lr, epoch, aug_fn,
             mixup_alpha: Optional[float] = None):
    """``pipelined_train_step`` on these as ``fn(views, raw_next)``, with the
    model's pipeline's loss guard (``LOSS_GUARD``).  It holds no reference
    to the trainer, so a trainer no longer used is freed, its graphs with
    it, as soon as its last reference goes."""
    guard = LOSS_GUARD[state.model.dim]

    def step(views: dict, raw_next: Optional[dict]):
        return pipelined_train_step(state, views, raw_next, aug_gen, level_gen, lr, epoch,
                                    aug_fn=aug_fn, mixup_alpha=mixup_alpha, loss_guard=guard)
    return step


class Trainer:
    """Drives the pipelined step over epochs on ``device`` (default: CUDA),
    there as CUDA graphs unless ``cuda_graph=False``; the model (``PCRLv23d``
    or ``PCRLv2``) picks the pipeline.

    ``group``: the data-parallel process group (``core/mesh.py``; None: one
    rank).  Each rank steps on its ``cfg.b / world`` rows of the global batch
    ``cfg.b`` and augments them on its own stream, seeded from (seed, rank);
    the levels' stream is the same on every rank.  Rank 0 writes the
    ``.pt`` and the train state, every rank its generators beside it and
    its own metrics file (``metrics_path``)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, aug_fn,
                 device=None, cuda_graph: bool = True, group=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.group = group
        self.rank, self.world = mesh.rank(group), mesh.world(group)
        self.state = TrainState(model, cfg.momentum, cfg.weight_decay, group)
        self.aug_fn = aug_fn
        self.aug_gen = torch.Generator(device=self.device).manual_seed(
            mesh.rank_seed(cfg.seed, self.rank))
        self.level_gen = torch.Generator(device=self.device).manual_seed(level_seed(cfg.seed))
        #: the epoch's learning rate and number, filled once per epoch
        self.lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self.epoch = torch.zeros((), dtype=torch.int64, device=self.device)
        self._eager_step = _step_fn(self.state, self.aug_gen, self.level_gen, self.lr,
                                    self.epoch, aug_fn, cfg.mixup)
        self.captured = (CapturedStep(self._eager_step, self.generators().values())
                         if cuda_graph and self.device.type == "cuda" else None)
        self.steps_run = 0
        os.makedirs(cfg.output, exist_ok=True)
        self.logger = MetricLogger(metrics_path(cfg.output, self.rank))

    def generators(self) -> dict:
        return {"aug": self.aug_gen, "level": self.level_gen}

    def to_device(self, raw: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in raw.items()}

    def step(self, views: dict, raw_next) -> tuple:
        """One step on ``views`` that also augments ``raw_next`` (None for an
        epoch's last step) → ``(metrics, next_views)``: a graph replay after
        the first ``GRAPH_WARMUP`` steps on a CUDA device, else eager."""
        batch = None if raw_next is None else self.to_device(raw_next)
        if self.captured is None or self.steps_run < GRAPH_WARMUP:
            out = self._eager_step(views, batch)
        else:
            out = self.captured(views, batch)
        self.steps_run += 1
        return out

    def train_epoch(self, epoch: int, batch_iter) -> dict:
        cfg = self.cfg
        lr = cosine_lr(epoch, cfg.lr, cfg.epochs)
        self.lr.fill_(lr)
        self.epoch.fill_(epoch)
        meters = {k: AverageMeter() for k in ("batch_time", "data_time") + _LOSSES}
        end = win_start = time.time()
        it = iter(batch_iter)
        raw = next(it, None)
        # the first batch's views; each later batch is augmented by the step
        # before it, as in the JAX trainer's pipelined program
        views = None if raw is None else self.aug_fn(self.aug_gen, self.to_device(raw))
        idx, metrics = -1, None
        while views is not None:
            idx += 1
            raw = next(it, None)  # the batch this step augments
            meters["data_time"].update(time.time() - end)
            # the step returns 0-d device tensors and reads nothing back, so
            # the host runs ahead; the metrics are read (a sync) only when
            # they are logged, as the JAX trainer does, and before the next
            # step (a replay) writes over them
            metrics, views = self.step(views, raw)
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
        ``cfg.eval_batches``; 0 = all).  Leaves the train state untouched.
        Under more than one rank each rank evaluates its slice, the sums and
        counts are added over the ranks, and a ragged tail is skipped as the
        JAX trainer skips it under multihost sharding."""
        if max_batches is None:
            max_batches = self.cfg.eval_batches
        model = self.state.model
        meters = {k: AverageMeter() for k in _LOSSES}
        for i, raw in enumerate(batch_iter):
            if max_batches and i >= max_batches:
                break
            if ragged_tail(raw, self.cfg.b, self.world):
                continue
            if model.dim == 2:
                gen = torch.Generator(device=self.device).manual_seed(
                    eval_aug_seed(mesh.rank_seed(self.cfg.seed, self.rank), i))
                views = self.aug_fn(gen, self.to_device(raw))
            else:
                views = raw_batch_to_views(self.to_device(raw))
            levels = eval_levels(self.cfg.seed, i, views["locals"].shape[1], model.n_levels)
            metrics = eval_step(model, views, levels)
            for k in meters:
                meters[k].update(float(metrics[k]), views["x1"].shape[0])
        if self.group is None:
            return {k: m.avg for k, m in meters.items()}
        sums = mesh.all_reduce_(torch.tensor(
            [m.sum for m in meters.values()] + [meters["loss"].count],
            dtype=torch.float64, device=self.device), self.group).tolist()
        return {k: s / max(sums[-1], 1) for k, s in zip(meters, sums)}

    def save_reference_ckpt(self, epoch: int) -> Optional[str]:
        """The reference's ``.pt``: the whole ``PCRLv23d``, or the 2D model's
        encoder (``train_2d.py:99``); written by rank 0 alone (the weights
        are the same on every rank), None elsewhere."""
        if not mesh.is_main(self.group):
            return None
        path = os.path.join(self.cfg.output, self.cfg.ckpt_name(epoch))
        model = self.state.model
        if model.dim == 2:
            export_resnet18_encoder(model.encoder, path, opt=vars(self.cfg), epoch=epoch)
        else:
            export_pcrlv23d(model, path, opt=vars(self.cfg), epoch=epoch)
        return path

    def load_encoder_weights(self, path: str) -> None:
        """The 2D encoder from a ResNet-18 ``.pt`` or torchvision state_dict
        (the ImageNet-init analog of the reference's smp default)."""
        if self.state.model.dim != 2:
            raise ValueError("--encoder_weights applies to the 2D pipeline")
        import_resnet18_encoder(path, self.state.model.encoder)

    def save_state(self, epoch: int) -> str:
        return save_train_state(self.cfg.state_dir, epoch, self.state,
                                self.generators(), self.rank)

    def restore_state(self, state_dir: str) -> int:
        """Load the train state saved in ``state_dir`` (this rank's
        generators); returns its epoch."""
        return load_train_state(state_dir, self.state, self.generators(), self.rank)


def profiled(profile_dir: Optional[str], device: torch.device):
    """A ``torch.profiler`` context whose trace (host and, on a CUDA device,
    device activity) is written into ``profile_dir`` as it closes (the JAX
    trainer's ``jax.profiler.trace``); a no-op without ``profile_dir``."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


#: what a 2D pretask run without ``--encoder_weights`` prints
#: (``pcrlv2_tpu/train/trainer.py:402-418``)
SCRATCH_WARNING = (
    "WARNING: 2D encoder initialized FROM SCRATCH — the reference starts from "
    "ImageNet weights. For reference-equivalent init:\n"
    "  python -c \"import torch,torchvision; torch.save(torchvision.models.resnet18("
    "weights='IMAGENET1K_V1').state_dict(), 'resnet18.pt')\"   # on any online machine\n"
    "  then pass --encoder_weights resnet18.pt")


def run_training(model: torch.nn.Module, cfg: TrainConfig, loader, aug_fn,
                 device=None, eval_loader=None, cuda_graph: bool = True,
                 group=None) -> Trainer:
    """Epochs 0..cfg.epochs, or from the epoch after the one saved in
    ``cfg.resume`` (reference epoch loop ``train_3d.py:60-83``; eval, save
    and profile cadence of the JAX trainer, ``trainer.py:419-457``), on a
    ``Trainer(..., cuda_graph=cuda_graph)``; the state is restored before any
    step, so before any capture.  ``cfg.encoder_weights``: the 2D encoder's
    initial weights (``Trainer.load_encoder_weights``); a 2D pretask run
    without them, and not resumed, says it starts from scratch.  On a CUDA
    device the run holds the GPU lock (``utils/chiplock.py``; it warns if
    another process holds it) and releases it however the run ends; under
    ``group`` the first rank of each host holds it for the job."""
    trainer = Trainer(model, cfg, aug_fn, device, cuda_graph, group)
    lock = (chiplock.guard_warn(f"trainer d={model.dim} n={cfg.n} output={cfg.output}")
            if trainer.device.type == "cuda" and mesh.local_rank(group) == 0 else None)
    try:
        if cfg.encoder_weights:
            trainer.load_encoder_weights(cfg.encoder_weights)
            print(f"==> encoder initialized from {cfg.encoder_weights}")
        elif model.dim == 2 and cfg.phase == "pretask" and not cfg.resume:
            print(SCRATCH_WARNING)
        start = 0
        if cfg.resume:
            start = trainer.restore_state(cfg.resume) + 1
            print(f"==> resumed at epoch {start} (global step {int(trainer.state.step)})")
        with profiled(cfg.profile_dir, trainer.device):
            for epoch in range(start, cfg.epochs + 1):
                run_epoch(trainer, epoch, loader, eval_loader)
    finally:
        trainer.logger.close()
        if lock is not None:
            lock.release()
    return trainer


def run_epoch(trainer: Trainer, epoch: int, loader, eval_loader=None) -> None:
    """One epoch of ``run_training``: train, log, evaluate and save on the
    configured cadences."""
    cfg = trainer.cfg
    print("==> training...")
    t0 = time.time()
    with torch.profiler.record_function(f"epoch {epoch}"), contextlib.closing(
            device_prefetch(loader.epoch(epoch), trainer.device)) as batches:
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
