"""Input mixup in the port's train step: its draws held to their
distribution, and the flagged pipelined step and CLI.  The loss and
gradient against ``make_loss_fn(mixup_alpha=...)`` in float64 are in
``test_torch_model.py``, which shares that file's JAX initialisation."""

import json
import os

import numpy as np
import pytest
import torch

from pcrlv2_tpu_torch.cli import main as cli
from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train.step import TrainState, draw_mixup, pipelined_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALPHA = 0.2


def test_mixup_draws_follow_their_distribution():
    """λ ≥ 0.5 and finite at α = 0.2 (where a Gamma(α) draw in f32 can be
    ~1e-8), its mean that of the folded Beta(α, α); perm a permutation."""
    gen = torch.Generator().manual_seed(0)
    draws = [draw_mixup(gen, ALPHA, 5) for _ in range(3000)]
    lam = torch.stack([d[0] for d in draws])
    assert bool(torch.isfinite(lam).all()) and float(lam.min()) >= 0.5
    assert float(lam.max()) <= 1.0
    ref = np.random.RandomState(0).beta(ALPHA, ALPHA, 200000)
    assert abs(float(lam.mean()) - np.maximum(ref, 1 - ref).mean()) < 0.01
    assert all(sorted(d[1].tolist()) == list(range(5)) for d in draws)
    assert len({tuple(d[1].tolist()) for d in draws}) > 100


def test_flagged_pipelined_step_reads_nothing_back(monkeypatch):
    """With mixup, painting, pixel shuffling and the exact affine, one
    pipelined step (mixup and levels drawn, step, next augmentation) calls
    no host read; its metrics are 0-d tensors and the loss is finite."""
    rng = np.random.RandomState(1)
    raw = {"pair": torch.from_numpy(rng.rand(2, 2, 16, 16, 8).astype(np.float32)),
           "locals": torch.from_numpy(rng.rand(2, 2, 8, 8, 8).astype(np.float32))}
    aug_fn = make_luna_aug_fn(use_painting=True, paint_rate=1.0, use_pixel_shuffle=True)
    monkeypatch.setenv("PCRL_AFFINE", "exact")
    gens = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    views = aug_fn(gens[0], raw)
    state = TrainState(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=4))

    def host_read(*_):
        raise AssertionError("the pipelined step read a tensor back to the host")

    with monkeypatch.context() as mp:
        for name in ("item", "__float__", "__int__", "__bool__", "tolist"):
            mp.setattr(torch.Tensor, name, host_read)
        metrics, next_views = pipelined_train_step(
            state, views, raw, *gens, torch.tensor(1e-3), torch.tensor(0), aug_fn=aug_fn,
            mixup_alpha=ALPHA)
    assert all(v.dim() == 0 for v in metrics.values())
    assert bool(torch.isfinite(metrics["loss"])) and int(state.step) == 1
    assert next_views["x1"].shape == views["x1"].shape


def test_cli_trains_with_the_new_flags(tmp_path, capsys):
    """``--use_painting --paint_rate --use_pixel_shuffle --mixup`` on a tiny
    tree through the native reader: finite losses, no skipped step."""
    rng = np.random.RandomState(0)
    tree = tmp_path / "tree"
    for s in range(10):
        os.makedirs(tree / f"subset{s}")
        np.save(tree / f"subset{s}" / f"1.2.{s}.0_global_0.npy",
                rng.rand(2, 16, 16, 8).astype(np.float32))
        np.save(tree / f"subset{s}" / f"1.2.{s}.0_local_0.npy",
                rng.rand(2, 8, 8, 8).astype(np.float32))
    out = tmp_path / "out"
    trainer = cli.main(["--data", str(tree), "--device", "cpu", "--b", "2", "--epochs", "0",
                        "--steps_per_epoch", "2", "--log_every", "1", "--output", str(out),
                        "--use_painting", "--paint_rate", "1.0", "--use_pixel_shuffle",
                        "--mixup", "0.2"])
    assert trainer.cfg.mixup == 0.2
    assert "==> reader: native" in capsys.readouterr().out
    rows = [json.loads(s) for s in open(out / "metrics.jsonl")]
    steps = [r for r in rows if "iter" in r]
    assert len(steps) == 2
    assert all(np.isfinite(r["loss"]) and r["skipped"] == 0.0 for r in steps)
