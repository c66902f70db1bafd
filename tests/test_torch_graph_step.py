"""The port's pipelined step (``pipelined_train_step``, the counterpart of
``make_pipelined_train_step``) and the step structure a CUDA graph needs:
levels, learning rate and epoch as device tensors, every level computed and
the drawn one selected, the state restored in place.  CPU, f32, on the
model of ``tests/test_torch_model.py`` at 8³ crops (about a second a step
on one CPU thread).  The graphs themselves need a GPU: ``chip_smoke.py``
phase 10 holds their replays to the eager loop bit for bit.
"""

import glob
import json

import numpy as np
import pytest
import torch

from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.ops import _build
from pcrlv2_tpu_torch.train.checkpoint import load_train_state, save_train_state
from pcrlv2_tpu_torch.train.optimizer import cosine_lr
from pcrlv2_tpu_torch.train.step import (TrainState, draw_levels, pipelined_train_step,
                                         train_step)
from pcrlv2_tpu_torch.train.trainer import TrainConfig, Trainer, level_seed, run_training


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (several run per host), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_VIEWS = 2


def _raw(seed, b=2):
    rng = np.random.RandomState(seed)
    return {"pair": rng.rand(b, 2, 8, 8, 8).astype(np.float32),
            "locals": rng.rand(b, N_VIEWS, 8, 8, 8).astype(np.float32)}


def _tensors(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _views(seed):
    return make_luna_aug_fn()(torch.Generator().manual_seed(seed), _tensors(_raw(seed)))


def _model(seed=3):
    return PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=seed)


def _assert_states_equal(a: TrainState, b: TrainState):
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip(a.optimizer.buffers, b.optimizer.buffers):
        assert torch.equal(x, y)
    assert torch.equal(a.step, b.step)


def _assert_metrics_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_pipelined_loop_matches_the_sequential_loop(tmp_path):
    """Two epochs of two batches: the trainer's pipelined loop (the first
    batch augmented up front, each step augmenting the next batch, an
    epoch's last step the step alone) against ``aug_fn`` + ``draw_levels``
    + ``train_step`` per batch on the same seeds.  Parameters, BN
    statistics, momentum, step counter, both generators and every step's
    metrics are equal bit for bit (``tests/test_train_step.py:114`` holds
    the JAX package's pipelined step to its sequential one)."""
    epochs = {0: [_raw(10), _raw(11)], 1: [_raw(12), _raw(13)]}
    cfg = TrainConfig(b=2, epochs=1, lr=0.05, log_every=1, seed=5, output=str(tmp_path))
    pipe = Trainer(_model(), cfg, make_luna_aug_fn(), "cpu")
    seen = []
    step = pipe.step

    def recorded(views, raw_next):
        metrics, next_views = step(views, raw_next)
        seen.append({k: v.clone() for k, v in metrics.items()})
        return metrics, next_views

    pipe.step = recorded
    for epoch, batches in epochs.items():
        pipe.train_epoch(epoch, batches)
    pipe.logger.close()

    seq = TrainState(_model(), cfg.momentum, cfg.weight_decay)
    aug_fn = make_luna_aug_fn()
    aug_gen = torch.Generator().manual_seed(cfg.seed)
    level_gen = torch.Generator().manual_seed(level_seed(cfg.seed))
    want = []
    for epoch, batches in epochs.items():
        for raw in batches:
            views = aug_fn(aug_gen, _tensors(raw))
            want.append(train_step(seq, views, draw_levels(level_gen, N_VIEWS),
                                   cosine_lr(epoch, cfg.lr, cfg.epochs), epoch))
    assert len(seen) == len(want) == 4
    for got, exp in zip(seen, want):
        _assert_metrics_equal(got, exp)
    _assert_states_equal(pipe.state, seq)
    assert int(seq.step) == 4
    assert torch.equal(pipe.aug_gen.get_state(), aug_gen.get_state())
    assert torch.equal(pipe.level_gen.get_state(), level_gen.get_state())


def test_device_tensors_match_lists_and_numbers():
    """``levels``, ``lr`` and ``epoch`` as tensors (what the trainer and a
    captured graph pass) against a list, a float and an int: the same step
    bit for bit."""
    views = _views(1)
    host, device = TrainState(_model()), TrainState(_model())
    a = train_step(host, views, [2, 0, 1, 1, 2], 0.01, 3)
    b = train_step(device, views, torch.tensor([2, 0, 1, 1, 2]),
                   torch.tensor(0.01, dtype=torch.float32), torch.tensor(3))
    _assert_metrics_equal(a, b)
    _assert_states_equal(host, device)
    assert int(a["level"]) == 2


def test_every_parameter_gets_a_gradient_and_unselected_levels_get_zero():
    """Every level's loss runs, so after one step every parameter has a
    gradient (the optimizer's with/without-gradient split is the same every
    step); with every level drawn 0, the heads that only levels 1 and 2
    reach (their projection BN, predictor and deep-supervision head) have a
    gradient of exactly zero, and level 0's heads do not."""
    model = _model()
    train_step(TrainState(model), _views(2), [0] * (1 + 2 * N_VIEWS), 1e-3, 0)
    grads = dict((n, p.grad) for n, p in model.named_parameters())
    assert all(g is not None for g in grads.values())
    heads = (".bn.", ".predictor_head.", ".deep_supervision_head.")
    for n, g in grads.items():
        if any(h in n for h in heads):
            if n.startswith(("up_tr128.", "up_tr64.")):
                assert torch.count_nonzero(g) == 0, n
    assert all(torch.count_nonzero(grads[n]) > 0 for n in grads
               if n.startswith("up_tr256.") and any(h in n for h in heads)
               and not n.endswith("bias"))


def test_guard_across_the_warmup_boundary_with_an_epoch_tensor():
    """With a guard every loss exceeds, a step at epoch 10 (the last warm-up
    epoch) still applies, one at epoch 11 is skipped and leaves the state
    bit-identical; the epoch is a 0-d device tensor, compared on the device."""
    views = _views(3)
    state = TrainState(_model())
    lr = torch.tensor(1e-3, dtype=torch.float32)
    levels = torch.tensor([1, 2, 0, 0, 1])
    m = train_step(state, views, levels, lr, torch.tensor(10), loss_guard=-1.0)
    assert m["skipped"].item() == 0.0 and state.step.item() == 1
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = [b.clone() for b in state.optimizer.buffers]
    m = train_step(state, views, levels, lr, torch.tensor(11), loss_guard=-1.0)
    assert m["skipped"].item() == 1.0 and state.step.item() == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, b in zip(state.optimizer.buffers, momentum):
        assert torch.equal(a, b)


def test_pipelined_step_reads_nothing_back(monkeypatch):
    """The pipelined step (levels drawn, the step, the next batch's
    augmentation) calls no ``Tensor.item`` / ``tolist`` / ``__float__`` /
    ``__int__`` / ``__bool__``, as a captured graph requires; it returns the
    next views and 0-d metrics."""
    state = TrainState(_model())
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    views, raw_next = _views(4), _tensors(_raw(5))
    lr, epoch = torch.tensor(1e-3, dtype=torch.float32), torch.tensor(20)

    def host_read(*_):
        raise AssertionError("the pipelined step read a tensor back to the host")

    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
            mp.setattr(torch.Tensor, name, host_read)
        metrics, next_views = pipelined_train_step(
            state, views, raw_next, *gens, lr, epoch, aug_fn=make_luna_aug_fn())
    assert all(v.dim() == 0 for v in metrics.values())
    assert {k: v.shape for k, v in next_views.items()} == {k: v.shape for k, v in views.items()}
    assert state.step.item() == 1


def test_load_train_state_restores_in_place(tmp_path):
    """``load_train_state`` writes into the tensors a captured graph holds:
    the step counter keeps its identity, as do parameters and momentum."""
    saved = TrainState(_model(seed=1))
    saved.step.fill_(7)
    with torch.no_grad():
        saved.optimizer.buffers[0].fill_(0.5)
    gens = {"aug": torch.Generator().manual_seed(1), "level": torch.Generator().manual_seed(2)}
    save_train_state(str(tmp_path), 4, saved, gens)
    state = TrainState(_model(seed=2))
    step, param, buf = state.step, next(state.model.parameters()), state.optimizer.buffers[0]
    assert load_train_state(str(tmp_path), state, gens) == 4
    assert state.step is step and int(step) == 7
    assert next(state.model.parameters()) is param and state.optimizer.buffers[0] is buf
    assert torch.equal(param, next(saved.model.parameters())) and torch.equal(buf, saved.optimizer.buffers[0])


class _OneBatch:
    def epoch(self, epoch):
        yield _raw(20 + epoch)


def test_profile_dir_writes_a_trace(tmp_path):
    """``profile_dir`` (``--profile_dir``): a one-step run leaves a
    ``torch.profiler`` trace there (host activity on the CPU) that holds the
    epoch's annotation."""
    prof = tmp_path / "prof"
    cfg = TrainConfig(b=2, epochs=0, seed=1, output=str(tmp_path / "out"),
                      profile_dir=str(prof))
    trainer = run_training(_model(), cfg, _OneBatch(), make_luna_aug_fn(), "cpu")
    assert trainer.captured is None and int(trainer.state.step) == 1
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert "epoch 0" in names


def test_capturing_counts_launches_apart():
    """Inside ``_build.capturing()`` the kernel wrappers' counts go to the
    graph's own counter (what one replay launches); outside, to
    ``_build.launches`` again."""
    _build.launches.clear()
    _build.launches["conv3d_fwd"] += 1
    with _build.capturing() as captured:
        _build.launches["conv3d_fwd"] += 2
        _build.launches["head_bwd"] += 1
    assert captured == {"conv3d_fwd": 2, "head_bwd": 1}
    assert _build.launches == {"conv3d_fwd": 1}
    _build.launches.clear()
