"""The port's trainer on the disk path: evaluation held against the JAX
loss on the same weights, views and levels; its views and draws; evaluation
leaves the train state as it was; resume continues an interrupted run bit
for bit; and the CLI trains, evaluates, saves and resumes from a processed
tree (CPU, f32).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.core.precision import PARITY_POLICY as JAX_PARITY_POLICY
from pcrlv2_tpu.models import PCRLv23d as JaxPCRLv23d
from pcrlv2_tpu.train import checkpoint as jax_ckpt
from pcrlv2_tpu.train.step import make_loss_fn
from pcrlv2_tpu.train.trainer import Trainer as JaxTrainer

from pcrlv2_tpu_torch.cli import main as cli
from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train import checkpoint as ckpt
from pcrlv2_tpu_torch.train.step import eval_step
from pcrlv2_tpu_torch.train.trainer import (TrainConfig, Trainer, eval_aug_seed, eval_levels,
                                            level_seed, raw_batch_to_views, run_training)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(seed, b=2, size=(16, 16, 8), local=(8, 8, 8), n_views=2):
    rng = np.random.RandomState(seed)
    return {"pair": rng.rand(b, 2, *size).astype(np.float32),
            "locals": rng.rand(b, n_views, *local).astype(np.float32)}


def jax_levels(key, n_views):
    """The levels ``make_loss_fn`` samples from ``key`` (its split order)."""
    key, k2 = jax.random.split(key)
    levels = [int(jax.random.randint(k2, (), 0, 3))]
    levels += [int(jax.random.randint(k, (), 0, 3))
               for k in jax.random.split(key, 2 * n_views)]
    return levels


def test_eval_metrics_match_the_jax_loss(tmp_path):
    """The JAX eval is ``make_loss_fn`` at epoch 0 on
    ``Trainer.raw_batch_to_views``; same weights (the port's, carried over
    by a ``.pt``), raw batch and levels, batch 4.  f32 on both sides, sums
    in another order: 1e-4 relative, as the train-step test holds the same
    loss."""
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=2)
    path = str(tmp_path / "w.pt")
    ckpt.export_pcrlv23d(model, path)
    variables, _ = jax_ckpt.import_pcrlv23d(path)
    raw = _raw(1, b=4)
    key = jax.random.key(5)
    levels = jax_levels(key, n_views=2)
    jviews = jax.tree.map(jnp.asarray, JaxTrainer.raw_batch_to_views(raw, 3))
    _, (_, want) = jax.jit(make_loss_fn(JaxPCRLv23d(policy=JAX_PARITY_POLICY), dim=3))(
        variables["params"], variables["batch_stats"], jviews, key, 0)
    got = eval_step(model, raw_batch_to_views(
        {k: torch.from_numpy(v) for k, v in raw.items()}), levels)
    for k in ("loss", "mg_loss", "cos_loss", "local_loss", "mask_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_eval_views_equal_the_jax_trainers():
    """``raw_batch_to_views`` on an f16 batch (``--h2d_dtype f16``) equals
    the JAX trainer's ``raw_batch_to_views(batch, 3)`` bit for bit: x1 = gt
    = crop 0, x2 = gt2 = crop 1, the locals, channels last, in f32."""
    raw = {k: v.astype(np.float16) for k, v in _raw(8, b=3).items()}
    got = raw_batch_to_views({k: torch.from_numpy(v) for k, v in raw.items()})
    want = JaxTrainer.raw_batch_to_views(raw, 3)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_eval_draws_depend_on_seed_and_batch_only():
    """Evaluation is the same on every pass: ``eval_levels`` (1 + 2·V levels
    in [0, n_levels)) and ``eval_aug_seed`` are functions of (seed, batch
    index); other batches and seeds draw otherwise, and the three streams
    (training levels, eval levels, eval augmentation) are apart."""
    draws = [eval_levels(4, i, 6, 5) for i in range(8)]
    assert draws == [eval_levels(4, i, 6, 5) for i in range(8)]
    assert all(len(d) == 13 and all(0 <= v < 5 for v in d) for d in draws)
    assert len({tuple(d) for d in draws}) > 1 and eval_levels(5, 0, 6, 5) != draws[0]
    seeds = {eval_aug_seed(4, i) for i in range(8)}
    assert len(seeds) == 8 and eval_aug_seed(4, 0) == eval_aug_seed(4, 0)
    assert level_seed(4) not in seeds | {4} and level_seed(4) != level_seed(5)


def test_evaluate_leaves_the_state_untouched_and_repeats(tmp_path):
    """After a train step: ``evaluate`` over a full and a short batch is the
    size-weighted mean of ``eval_step`` at ``eval_levels``, the same on a
    second pass, capped by ``max_batches``; parameters, BN statistics,
    momentum and step counter come out bit for bit as they went in."""
    cfg = TrainConfig(b=2, output=str(tmp_path), seed=4)
    trainer = Trainer(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=4), cfg,
                      make_luna_aug_fn(), "cpu")
    trainer.train_epoch(0, [_raw(0)])
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    momentum = [b.clone() for b in trainer.state.optimizer.buffers]
    batches = [_raw(2), _raw(3, b=1)]
    ev = trainer.evaluate(batches)
    assert trainer.evaluate(batches) == ev
    want = {k: 0.0 for k in ev}
    for i, raw in enumerate(batches):
        views = raw_batch_to_views({k: torch.from_numpy(v) for k, v in raw.items()})
        m = eval_step(trainer.state.model, views, eval_levels(cfg.seed, i, 2))
        for k in want:
            want[k] += float(m[k]) * len(raw["pair"]) / 3
    for k in want:
        assert math.isfinite(ev[k])
        np.testing.assert_allclose(ev[k], want[k], rtol=1e-6, err_msg=k)
    first = trainer.evaluate(batches, max_batches=1)
    assert first != ev and first == trainer.evaluate(batches[:1])
    for k, v in trainer.state.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    for a, b in zip(trainer.state.optimizer.buffers, momentum):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert trainer.state.step == 1


class _Interrupted(Exception):
    pass


class _Loader:
    """One batch per epoch, made from the epoch; optionally stops the run at
    the start of epoch ``fail_at``, as a killed job would."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at

    def epoch(self, epoch):
        if epoch == self.fail_at:
            raise _Interrupted
        yield _raw(10 + epoch)


def _rows(path):
    return [json.loads(s) for s in open(path)]


def test_resume_continues_an_interrupted_run_exactly(tmp_path):
    """Epochs 0-2 straight against epoch 0, a kill at the start of epoch 1,
    and a resume (fresh model from another seed) through epoch 2: the same
    parameters, BN statistics, momentum, step counter and per-step losses,
    bit for bit (the generators' states are part of the train state)."""
    straight = run_training(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=6),
                            TrainConfig(b=2, epochs=2, save_every=1, log_every=1, seed=6,
                                        output=str(tmp_path / "a")),
                            _Loader(), make_luna_aug_fn(), "cpu")
    cfg = TrainConfig(b=2, epochs=2, save_every=1, log_every=1, seed=6,
                      output=str(tmp_path / "b"))
    with pytest.raises(_Interrupted):
        run_training(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=6), cfg,
                     _Loader(fail_at=1), make_luna_aug_fn(), "cpu")
    cfg.resume = cfg.state_dir
    resumed = run_training(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=9), cfg,
                           _Loader(), make_luna_aug_fn(), "cpu")
    assert straight.state.step == resumed.state.step == 3
    for (k, a), b in zip(straight.state.model.state_dict().items(),
                         resumed.state.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    for a, b in zip(straight.state.optimizer.buffers, resumed.state.optimizer.buffers):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    steps = lambda d: [{k: r[k] for k in ("epoch", "iter", "lr", "loss", "cos_loss")}
                       for r in _rows(tmp_path / d / "metrics.jsonl") if "iter" in r]
    assert steps("b") == steps("a") and len(steps("a")) == 3
    with pytest.raises(FileNotFoundError, match="no train state"):
        Trainer(PCRLv23d(device="cpu"), TrainConfig(output=str(tmp_path / "c")),
                make_luna_aug_fn(), "cpu").restore_state(str(tmp_path / "c"))


def _tiny_tree(root):
    """A processed-LUNA layout at 16×16×8 crops with 2 local views of 8³:
    10 subsets of one UID with 2 pairs (14 train crops, 6 held out)."""
    rng = np.random.RandomState(0)
    for s in range(10):
        d = os.path.join(root, f"subset{s}")
        os.makedirs(d)
        for k in range(2):
            np.save(os.path.join(d, f"1.2.{s}.0_global_{k}.npy"),
                    rng.rand(2, 16, 16, 8).astype(np.float32))
            np.save(os.path.join(d, f"1.2.{s}.0_local_{k}.npy"),
                    rng.rand(2, 8, 8, 8).astype(np.float32))


def test_cli_trains_evaluates_saves_and_resumes_from_disk(tmp_path, capsys, monkeypatch):
    """``--data`` with no UID list: the list is derived into ``--output``;
    each epoch trains one batch, evaluates one and saves the train state;
    ``--resume`` continues at the next epoch, and the reference ``.pt``
    loads strictly into a fresh model."""
    monkeypatch.chdir(tmp_path)
    tree, out = str(tmp_path / "tree"), str(tmp_path / "out")
    _tiny_tree(tree)
    argv = ["--data", tree, "--device", "cpu", "--b", "2", "--steps_per_epoch", "1",
            "--eval_every", "1", "--eval_batches", "1", "--save_every", "1",
            "--log_every", "1", "--output", out]
    cli.main(argv + ["--epochs", "0"])
    assert open(os.path.join(out, "luna_train.txt")).read().split() == \
        [f"1.2.{s}.0" for s in range(10)]
    cli.main(argv + ["--epochs", "1", "--resume", os.path.join(out, "train_state")])
    text = capsys.readouterr().out
    assert "total train images 14, validation images 6" in text
    assert "==> resumed at epoch 1 (global step 1)" in text
    rows = _rows(os.path.join(out, "metrics.jsonl"))
    assert [r["epoch"] for r in rows if "iter" in r] == [0, 1]
    evals = [r for r in rows if "eval" in r]
    assert [r["epoch"] for r in evals] == [0, 1]
    assert all(math.isfinite(v) for r in evals for v in r["eval"].values())
    state = torch.load(os.path.join(out, "train_state", "state.pt"), weights_only=True)
    assert (state["epoch"], state["step"]) == (1, 2)
    ckpt.import_pcrlv23d(os.path.join(out, "pcrlv2_luna_pretask_1.0_0.pt"),
                         PCRLv23d(device="cpu", seed=1))
    with pytest.raises(FileNotFoundError, match="no train state"):
        cli.main(argv + ["--resume", str(tmp_path / "nowhere")])
