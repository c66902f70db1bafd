"""The port's plain tensor ops, norms, losses and optimizer held against the
JAX package on the same numpy inputs (CPU, f32)."""

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.ops import global_avg_pool as jax_gap
from pcrlv2_tpu.ops import max_pool3d as jax_max_pool3d
from pcrlv2_tpu.ops import upsample_linear as jax_upsample
from pcrlv2_tpu.train import losses as jax_losses
from pcrlv2_tpu.train import optimizer as jax_opt

from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.models.layers import BatchNorm, GroupNorm, PReLU
from pcrlv2_tpu_torch.ops.pooling import global_avg_pool, max_pool3d
from pcrlv2_tpu_torch.ops.resize import upsample_linear
from pcrlv2_tpu_torch.train import losses
from pcrlv2_tpu_torch.train.optimizer import SGD, cosine_lr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_max_pool_ties_route_gradient_to_first_max():
    """Post-ReLU inputs are full of tied zeros: the gradient must reach the
    first max of each window in (d, h, w) order, as JAX's select-and-scatter
    backward does."""
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(2, 4, 6, 4, 3), 0).astype(np.float32)
    x[0, :2, :2, :2, 0] = 0.5  # a window of eight equal maxima
    g = rng.randn(2, 2, 3, 2, 3).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_max_pool3d(v) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = max_pool3d(xt)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jax_max_pool3d(jnp.asarray(x))))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_matches_jax(scale):
    x = np.random.RandomState(1).rand(2, 4, 4, 2, 1).astype(np.float32)
    got = upsample_linear(torch.from_numpy(x), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_upsample(jnp.asarray(x), scale)),
                               rtol=1e-6, atol=1e-6)


def test_global_avg_pool_matches_jax():
    x = np.random.RandomState(2).randn(3, 4, 4, 2, 5).astype(np.float32)
    np.testing.assert_allclose(global_avg_pool(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gap(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 6), (2, 3, 3, 2, 6)])
def test_batch_norm_matches_flax_with_running_stats(shape):
    """Train mode (batch statistics, biased running-variance update with
    momentum 0.9), then eval mode on the running statistics."""
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    scale, bias = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32)
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    y, upd = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(6, PARITY_POLICY)
    bn.weight.data = torch.from_numpy(scale)
    bn.bias.data = torch.from_numpy(bias)
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)
    bn.eval()
    y_eval = nn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(y_eval), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [2, 8])
def test_group_norm_matches_flax(groups):
    """``gn`` (8 groups) and ``in`` (one group per channel) norms."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 3, 4, 2, 8) * 3).astype(np.float32)
    scale, bias = rng.rand(8).astype(np.float32), rng.randn(8).astype(np.float32)
    want = nn.GroupNorm(num_groups=groups, epsilon=1e-5).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    gn = GroupNorm(groups, 8, PARITY_POLICY)
    gn.weight.data = torch.from_numpy(scale)
    gn.bias.data = torch.from_numpy(bias)
    np.testing.assert_allclose(gn(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_prelu():
    act = PReLU(3, PARITY_POLICY)
    x = torch.tensor([[-2.0, 0.0, 3.0]])
    torch.testing.assert_close(act(x), torch.tensor([[-0.5, 0.0, 3.0]]))


def test_losses_match_jax():
    rng = np.random.RandomState(5)
    feats = [[(rng.randn(4, c).astype(np.float32), rng.randn(4, c).astype(np.float32))
              for c in (8, 4, 2)] for _ in range(2)]
    key = jax.random.key(3)
    want, level = jax_losses.cos_loss(key, *[[tuple(map(jnp.asarray, p)) for p in f]
                                             for f in feats])
    got = losses.cos_loss(int(level), *[[tuple(map(torch.from_numpy, p)) for p in f]
                                        for f in feats])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    a, b = rng.rand(2, 3, 4).astype(np.float32), rng.rand(2, 3, 4).astype(np.float32)
    np.testing.assert_allclose(float(losses.mse_loss(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jax_losses.mse_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    for epoch in (0, 60, 240):
        np.testing.assert_allclose(losses.beta_schedule(epoch),
                                   float(jax_losses.beta_schedule(epoch)), rtol=1e-6)


def test_sgd_matches_torch_sgd():
    """torch.optim.SGD(momentum, weight_decay) semantics, incl. a parameter
    without a gradient (zero gradient: decay and momentum still move it)."""
    w0 = torch.tensor([1.0, -2.0, 3.0])
    grads = [torch.tensor([0.1, 0.2, -0.3]), None, torch.tensor([-0.2, 0.1, 0.4])]
    ref = torch.nn.Parameter(w0.clone())
    opt = torch.optim.SGD([ref], lr=0.01, momentum=0.9, weight_decay=1e-4)
    mine = torch.nn.Parameter(w0.clone())
    sgd = SGD([mine], momentum=0.9, weight_decay=1e-4)
    for g in grads:
        ref.grad = torch.zeros(3) if g is None else g.clone()
        opt.step()
        mine.grad = None if g is None else g.clone()
        sgd.step(0.01)
    torch.testing.assert_close(mine.detach(), ref.detach(), rtol=1e-6, atol=1e-7)


def test_sgd_matches_jax_sgd():
    """Three steps of the JAX package's ``sgd()`` + ``apply_lr`` and of the
    port's SGD on the same parameters and gradients, one leaf without a
    gradient (JAX gives it a zero gradient): parameters and momentum
    buffers (``opt_state[1].trace``) after every step."""
    rng = np.random.RandomState(6)
    shapes = {"w": (4, 3), "b": (3,), "unused": (2, 2)}
    params = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
    grads = [{k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()
              if k != "unused"} for _ in range(3)]
    lrs = [1e-2, 5e-3, 1e-3]
    tx = jax_opt.sgd(momentum=0.9, weight_decay=1e-4)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    names = list(shapes)
    mine = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in names]
    sgd = SGD(mine, momentum=0.9, weight_decay=1e-4)
    for g, lr in zip(grads, lrs):
        jg = {k: jnp.asarray(g.get(k, np.zeros(shapes[k], np.float32))) for k in names}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jax_opt.apply_lr(updates, lr))
        for k, p in zip(names, mine):
            p.grad = torch.from_numpy(g[k]) if k in g else None
        sgd.step(lr)
        for k, p, buf in zip(names, mine, sgd.buffers):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(buf.numpy(), np.asarray(jstate[1].trace[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"momentum {k}")


def test_cosine_lr():
    """Per-epoch cosine LR against the JAX package's; ``--epochs 0`` counts
    as one epoch."""
    for epoch, total in ((0, 240), (60, 240), (240, 240), (0, 0)):
        np.testing.assert_allclose(cosine_lr(epoch, 1e-3, total),
                                   float(jax_opt.cosine_lr(epoch, 1e-3, total)),
                                   rtol=1e-6, err_msg=f"epoch {epoch} of {total}")
