"""Activation checkpointing of the port's ``PCRLv23d(remat=True)`` (the JAX
``PCRLv23d(remat=True)``'s ``nn.remat`` of each transition) on the CPU: a
remat train step equals the plain step bit for bit (loss, every gradient,
parameters, BN statistics, ``num_batches_tracked`` advanced once a forward),
reads nothing back, relaunches exactly the forwards of #1 and #3 inside the
backward, and keeps the reference ``state_dict`` keys, so its ``.pt`` loads
strictly into a plain model and into the JAX package's mapping.  The same
step under a 2-rank gloo group is a case of
``tests/torch_port/test_torch_data_parallel.py`` (it reuses that file's
ranks)."""

import collections

import numpy as np
import pytest
import torch

import jax

from pcrlv2_tpu.core.precision import PARITY_POLICY as JAX_PARITY_POLICY
from pcrlv2_tpu.models.unet3d import PCRLv23d as JaxPCRLv23d
from pcrlv2_tpu.train import checkpoint as jax_ckpt

from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.ops import conv3d_kernel, head_conv
from pcrlv2_tpu_torch.train import checkpoint as ckpt
from pcrlv2_tpu_torch.train.step import TrainState, train_step

LEVELS = [0, 1, 2, 0, 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several a host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _views(seed=0, b=4):
    rng = np.random.RandomState(seed)
    views = {"x1": rng.rand(b, 16, 16, 8, 1), "x2": rng.rand(b, 16, 16, 8, 1),
             "gt": rng.rand(b, 16, 16, 8, 1), "locals": rng.rand(b, 2, 8, 8, 8, 1)}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in views.items()}


def _counted(monkeypatch):
    """Calls of the plain versions of #1 (forward and dx), #2, #3 and #4:
    on the CPU the wrappers run them where on the card they launch."""
    calls = collections.Counter()
    for module, name in ((conv3d_kernel, "conv3d_fwd_plain"), (conv3d_kernel, "conv3d_dw_plain"),
                         (head_conv, "head_fwd_plain"), (head_conv, "head_bwd_plain")):
        def counted(*args, _fn=getattr(module, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(module, name, counted)
    return calls


def _step(remat, monkeypatch, reads_back=True):
    """One ``train_step`` from seed 0's weights: (metrics, gradients, state
    after the step, plain-version calls)."""
    tstate = TrainState(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=0, remat=remat))
    with monkeypatch.context() as mp:
        calls = _counted(mp)
        if not reads_back:
            def host_read(*_):
                raise AssertionError("the remat step read a tensor back to the host")
            for name in ("item", "__float__", "__int__", "__bool__"):
                mp.setattr(torch.Tensor, name, host_read)
        metrics = train_step(tstate, _views(), LEVELS, 1e-3, 20)
    grads = {n: p.grad.clone() for n, p in tstate.model.named_parameters()}
    return metrics, grads, tstate.model.state_dict(), calls


def test_remat_step_equals_the_plain_step(monkeypatch):
    want_m, want_g, want_s, plain_calls = _step(False, monkeypatch)
    got_m, got_g, got_s, remat_calls = _step(True, monkeypatch, reads_back=False)
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    assert set(got_g) == set(want_g)
    for k in want_g:
        assert torch.equal(got_g[k], want_g[k]), k
    assert list(got_s) == list(want_s)
    for k in want_s:
        assert torch.equal(got_s[k], want_s[k]), k
    # three forwards a step (x1, x2, the locals): each BatchNorm counts three
    tracked = {int(v) for k, v in got_s.items() if k.endswith("num_batches_tracked")}
    assert tracked == {3}
    # 14 3³ convs and 3 heads a model call, 3 calls: the recomputed forwards
    # add one #1 forward a conv and one #3 forward a head inside the backward
    assert plain_calls == {"conv3d_fwd_plain": 42 + 39, "conv3d_dw_plain": 42,
                           "head_fwd_plain": 9, "head_bwd_plain": 3}
    assert remat_calls == plain_calls + collections.Counter(conv3d_fwd_plain=42,
                                                            head_fwd_plain=9)


def test_remat_is_off_without_gradients(monkeypatch):
    """Under ``no_grad`` (eval) the transitions run once, as without remat,
    and BatchNorm in training mode advances its statistics once."""
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=0, remat=True)
    plain = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=0)
    x = _views()["x1"]
    with monkeypatch.context() as mp, torch.no_grad():
        calls = _counted(mp)
        got = model(x)
    assert calls == {"conv3d_fwd_plain": 14, "head_fwd_plain": 3}
    with torch.no_grad():
        want = plain(x)
    assert torch.equal(got[0], want[0])
    for (k, a), b in zip(model.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(a, b), k


def test_remat_keys_and_strict_loads(tmp_path):
    """The remat model's ``state_dict`` keys are the reference ``PCRLv23d``'s
    (no ``_checkpoint_wrapped_module``); its ``.pt`` loads strictly into a
    plain model, and into the JAX package's mapping as the tree of the JAX
    ``PCRLv23d(remat=True)``."""
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=3, remat=True)
    plain = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=4)
    assert list(model.state_dict()) == list(plain.state_dict())
    assert not any("_checkpoint" in k for k in model.state_dict())
    path = str(tmp_path / "remat.pt")
    ckpt.export_pcrlv23d(model, path)
    ckpt.import_pcrlv23d(path, plain)
    for k, v in model.state_dict().items():
        assert torch.equal(plain.state_dict()[k], v), k
    back = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=5, remat=True)
    ckpt.import_pcrlv23d(path, back)
    variables, _ = jax_ckpt.import_pcrlv23d(path)
    shapes = jax.eval_shape(
        lambda: JaxPCRLv23d(policy=JAX_PARITY_POLICY, remat=True).init(
            jax.random.key(0), jax.numpy.zeros((2, 16, 16, 8, 1)), train=True))
    assert jax.tree.structure(variables) == jax.tree.structure(shapes)
    for got, want in zip(jax.tree.leaves(variables), jax.tree.leaves(shapes)):
        assert got.shape == want.shape
