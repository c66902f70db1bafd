"""The port's 2D chest model (``PCRLv2``), its ops, its train step and its
encoder checkpoint held against the JAX package on the same weights and
inputs (CPU, f32; the gradient against a float64 JAX run).

One set of weights serves both sides: the port's ``PCRLv2`` (seed 0) carried
into the JAX package's variables by its own ``torch_state_to_flax``, so the
JAX model is never initialized here.  The JAX side runs in float64 (an f64
``Policy``, x64 enabled): its own f32 BatchNorm statistics are off from
float64 by ~2e-5 of the stem's output already (XLA's CPU reductions), 15×
the port's f32 error there, so the f32 JAX model cannot hold the port to
f32 rounding.  The JAX forwards run as one jitted program and the loss and
gradient as another, each once per file (module fixtures), since each shape
compiles anew, their convs traced as products (``tests/f64_reference.py``:
XLA's float64 CPU conv is a plain loop nest).  Sizes: b = 4, 64² global views, 2 local views of 32² (sides
a multiple of 32, the encoder's stride).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.core.precision import Policy as JaxPolicy
from pcrlv2_tpu.models import PCRLv2 as JaxPCRLv2
from pcrlv2_tpu.ops import blur as jblur
from pcrlv2_tpu.ops import convolution as jconv
from pcrlv2_tpu.ops import pooling as jpool
from pcrlv2_tpu.ops import resize as jresize
from pcrlv2_tpu.train import checkpoint as jax_ckpt
from pcrlv2_tpu.train.step import make_loss_fn

from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.data.augment2d import make_chest_aug_fn
from pcrlv2_tpu_torch.models.resnet import ResNet18Encoder
from pcrlv2_tpu_torch.models.unet2d import PCRLv2
from pcrlv2_tpu_torch.ops import blur
from pcrlv2_tpu_torch.ops.convolution import conv2d
from pcrlv2_tpu_torch.ops.pooling import max_pool2d
from pcrlv2_tpu_torch.ops.resize import upsample_nearest2x_2d
from pcrlv2_tpu_torch.train import checkpoint as ckpt
from pcrlv2_tpu_torch.train.step import (LOSS_GUARD, TrainState, draw_levels, loss_fn,
                                         pipelined_train_step, train_step)

from tests.f64_reference import convs_as_products


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, SIZE, LOCAL, N_VIEWS = 4, 64, 32, 2
MAPPING = ckpt.pcrlv2_2d_mapping()
# the port's f32 against float64, per tensor: the largest error at most this
# share of the tensor's largest entry (the port reads 3e-5 at the output:
# BatchNorm over 16 values a channel in the deepest stage amplifies f32
# rounding, as in the 3D model)
FWD_REL = 1e-4
# the projections and predictions pass BatchNorm1d over 4 (global) or 8
# (local) pooled samples: where a channel's spread is near sqrt(eps), a 1e-6
# difference in the pooled features becomes ~1e-3 (as in the 3D test)
FEAT_TOL = dict(rtol=1e-4, atol=2e-3)


def _image(seed, n, size):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def _views(seed, b=B, size=SIZE, local=LOCAL):
    rng = np.random.RandomState(seed)
    return {"x1": rng.rand(b, size, size, 3).astype(np.float32),
            "x2": rng.rand(b, size, size, 3).astype(np.float32),
            "gt": rng.rand(b, size, size, 3).astype(np.float32),
            "locals": rng.rand(b, N_VIEWS, local, local, 3).astype(np.float32)}


def _port(variables, policy=PARITY_POLICY):
    model = PCRLv2(policy=policy, device="cpu", seed=1)
    model.load_state_dict(ckpt.from_jax_variables(jax.device_get(variables), mapping=MAPPING),
                          strict=True)
    return model.train()


def _close(got, want, rel=FWD_REL, what=""):
    """max |got − want| ≤ ``rel`` · max |want| + 1e-6 (the floor is for
    statistics whose true value is 0, such as the running mean of a Linear
    over batch-normalized inputs: both sides hold rounding noise there)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale + 1e-6, f"{what}: {err:.3e} > {rel} × {scale:.3e} + 1e-6"


def _assert_state_close(model, variables):
    want = ckpt.from_jax_variables(jax.device_get(variables), mapping=MAPPING)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            _close(got[k].detach().numpy(), v.numpy(), what=k)


@pytest.fixture(scope="module")
def weights():
    """The port's seed-0 weights as JAX variables (``torch_state_to_flax``)."""
    model = PCRLv2(policy=PARITY_POLICY, device="cpu", seed=0)
    return jax_ckpt.torch_state_to_flax(model.state_dict(), MAPPING)


F64 = JaxPolicy(param_dtype=jnp.float64, compute_dtype=jnp.float64, output_dtype=jnp.float64)


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def jax_forwards(weights):
    """JAX ``PCRLv2`` in float64, in train mode on global and on local views
    (with its updated statistics) and in eval mode (statistics moved by
    0.25), one jitted program."""
    xg, xl = _image(3, B, SIZE), _image(4, B * N_VIEWS, LOCAL)
    eval_stats = jax.tree.map(lambda v: v + 0.25, weights["batch_stats"])
    with jax.enable_x64(True), convs_as_products():
        model = JaxPCRLv2(policy=F64)

        @jax.jit
        def run(params, stats, eval_stats, xg, xl):
            def train(x, local):
                return model.apply({"params": params, "batch_stats": stats}, x, local=local,
                                   train=True, mutable=["batch_stats"])
            return (train(xg, False), train(xl, True),
                    model.apply({"params": params, "batch_stats": eval_stats}, xg, train=False))

        out = jax.device_get(run(*_to64((weights["params"], weights["batch_stats"],
                                         eval_stats, xg, xl))))
    return {"xg": xg, "xl": xl, "eval_stats": eval_stats, "out": out}


def test_state_dict_is_the_reference_schema():
    """The port's keys are the mapping's plus the BN counters, for the model
    and for the encoder alone; the port's tables equal the JAX package's."""
    assert MAPPING == jax_ckpt.pcrlv2_2d_mapping()
    assert ckpt.resnet18_encoder_mapping() == jax_ckpt.resnet18_encoder_mapping()
    model = PCRLv2(device="cpu")
    for keys, mapping in ((set(model.state_dict()), MAPPING),
                          (set(model.encoder.state_dict()), ckpt.resnet18_encoder_mapping())):
        mapped = {k for k, _, _ in mapping}
        counters = {k[:-len("running_var")] + "num_batches_tracked"
                    for k in mapped if k.endswith(".running_var")}
        assert keys == mapped | counters
    assert (PCRLv2.n_levels, PCRLv2.dim) == (5, 2)


@pytest.mark.parametrize("local", [False, True])
def test_forward_matches_jax(weights, jax_forwards, local):
    """Train-mode forward on global views (the segmentation output, 5 masks
    upsampled to the input, 5 (pro, pre) pairs) or local views (pairs only),
    and the running statistics after the call (flax: biased variance)."""
    (jfeats, jout, jmasks), upd = jax_forwards["out"][1 if local else 0]
    x = jax_forwards["xl" if local else "xg"]
    model = _port(weights)
    with torch.no_grad():
        feats, out, masks = model(torch.from_numpy(x), local=local)
    if local:
        assert out is None and jout is None and masks == [] and len(jmasks) == 0
    else:
        _close(out.numpy(), jout, what="out")
        assert len(masks) == len(jmasks) == 5
        for i, (m, jm) in enumerate(zip(masks, jmasks)):
            assert m.shape == jm.shape == (B, SIZE, SIZE, 3)
            _close(m.numpy(), jm, what=f"mask {i}")
    assert len(feats) == len(jfeats) == 5
    for (pro, pre), (jpro, jpre) in zip(feats, jfeats):
        np.testing.assert_allclose(pro.numpy(), jpro, **FEAT_TOL)
        np.testing.assert_allclose(pre.numpy(), jpre, **FEAT_TOL)
    _assert_state_close(model, {"params": weights["params"], "batch_stats": upd["batch_stats"]})


def test_eval_forward_matches_jax(weights, jax_forwards):
    jfeats, jout, jmasks = jax_forwards["out"][2]
    model = _port({"params": weights["params"], "batch_stats": jax_forwards["eval_stats"]})
    model.eval()
    with torch.no_grad():
        feats, out, masks = model(torch.from_numpy(jax_forwards["xg"]))
    _close(out.numpy(), jout, what="out")
    for i, (m, jm) in enumerate(zip(masks, jmasks)):
        _close(m.numpy(), jm, what=f"mask {i}")
    for i, ((pro, pre), (jpro, jpre)) in enumerate(zip(feats, jfeats)):
        _close(pro.numpy(), jpro, what=f"pro {i}")
        _close(pre.numpy(), jpre, what=f"pre {i}")


def jax_levels(key, n_views, n_levels=5):
    """The levels ``make_loss_fn`` samples from ``key`` (its split order)."""
    key, k2 = jax.random.split(key)
    levels = [int(jax.random.randint(k2, (), 0, n_levels))]
    levels += [int(jax.random.randint(k, (), 0, n_levels))
               for k in jax.random.split(key, 2 * n_views)]
    return levels


@pytest.fixture(scope="module")
def f64_run(weights):
    """``make_loss_fn(PCRLv2, dim=2)`` and its gradient, jitted, in float64
    (an f64 ``Policy``, x64 enabled) at key 21: the levels (drawn under x64,
    which changes ``jax.random``'s integer draws), the loss, its metrics and
    the gradient in the port's schema."""
    views = _views(7)
    key = jax.random.key(21)
    with jax.enable_x64(True), convs_as_products():
        levels = jax_levels(key, N_VIEWS)
        jloss = make_loss_fn(JaxPCRLv2(policy=F64), dim=2)
        (value, (_, metrics)), grads = jax.jit(jax.value_and_grad(
            lambda p, s, v: jloss(p, s, v, key, 0), has_aux=True))(
            *_to64((weights["params"], weights["batch_stats"], views)))
        # rounded to f32 on the way: 6e-8 relative, far below the tolerances
        grads = ckpt.from_jax_variables(
            {"params": jax.device_get(grads),
             "batch_stats": jax.device_get(weights["batch_stats"])}, mapping=MAPPING)
        metrics = {k: float(v) for k, v in jax.device_get(metrics).items()}
    model = _port(weights)
    loss, port_metrics = loss_fn(model, {k: torch.from_numpy(v) for k, v in views.items()},
                                 levels, 0)
    loss.backward()
    return {"levels": levels, "value": float(value), "metrics": metrics, "grads": grads,
            "model": model, "loss": float(loss.detach()), "port_metrics": port_metrics}


#: parameters whose true gradient is 0: biases that feed a BatchNorm (its
#: mean subtraction cancels them), so both gradients are rounding noise
_FEED_BN = ("deep_supervision_head.0.bias", "predictor_head.0.bias", ".bn.bias")


#: (name prefix, tolerance) of the gradient test, the first match wins: the
#: largest error per tensor as a share of its largest float64 entry.  At
#: this size the f32 gradient of the encoder is ill-conditioned: BatchNorm
#: normalizes each channel of its last stages over 16 (global views: 2×2 × 4)
#: or 8 (local views: 1×1 × 8) values.  JAX's own f32 gradient, on the same
#: weights, views and key, is off from its float64 one by up to 9.4e-2 in
#: layer3-4, 1.8e-2 in the rest of the encoder and 5.1e-2 in the decoder;
#: the port's by 8.6e-2, 1.4e-2 and 4.5e-3 (and the port run in float64
#: matched JAX's float64 gradient to 3e-6 everywhere).  Each tolerance is
#: about twice the port's error; the real sizes normalize over 864 values
#: or more.
_GRAD_REL = (("model.encoder.layer3.", 0.15), ("model.encoder.layer4.", 0.15),
             ("model.encoder.", 3e-2), ("", 1e-2))


def test_gradient_matches_jax_float64(f64_run):
    """The port's f32 gradient of the 2D 4-term loss against the float64 JAX
    gradient, same weights, views and levels: per tensor, the largest error
    within ``_GRAD_REL`` of the tensor's largest float64 entry, and exactly 0
    where the reference is 0 (the heads of the levels not drawn)."""
    assert f64_run["levels"][0] == f64_run["metrics"]["level"]
    for name, p in f64_run["model"].named_parameters():
        ref = f64_run["grads"][name].numpy()
        assert p.grad is not None, name
        if not np.abs(ref).max():
            assert not p.grad.abs().max(), name
            continue
        if name.endswith(_FEED_BN):
            continue
        rel = next(tol for prefix, tol in _GRAD_REL if name.startswith(prefix))
        err = np.abs(p.grad.double().numpy() - ref).max()
        assert err <= rel * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_loss_terms_match_jax_float64(f64_run):
    """The loss and its four terms from the same float64 run, within 1e-4
    relative (1e-6 absolute for the terms near 0), and the drawn level."""
    got, want = f64_run["port_metrics"], f64_run["metrics"]
    np.testing.assert_allclose(f64_run["loss"], f64_run["value"], rtol=1e-4)
    for k in ("loss", "mg_loss", "cos_loss", "local_loss", "mask_loss"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert 0 <= int(want["level"]) < 5


def _snapshot(tstate):
    return ({k: v.clone() for k, v in tstate.model.state_dict().items()},
            [b.clone() for b in tstate.optimizer.buffers], tstate.step.clone())


def test_train_step_2d_levels_and_guard(monkeypatch):
    """The port's step at dim = 2, no JAX: the pipelined step (levels drawn,
    the step, the next batch's chest augmentation from uint8 grey) reads
    nothing back to the host (no ``Tensor.item`` / ``tolist`` /
    ``__float__`` / ``__int__`` / ``__bool__``, as a captured graph
    requires) and draws 1 + 2·V levels in [0, 5) (every level appears over
    40 draws of the generator it uses); a NaN reverts parameters, momentum,
    BN statistics and the step counter bit for bit; a large finite loss
    after the warm-up epochs is not skipped (the 2D step has no loss guard,
    ``LOSS_GUARD[2]``).  At b = 2 and 32² views: nothing here depends on
    the size."""
    gen = torch.Generator().manual_seed(0)
    drawn = torch.stack([draw_levels(gen, N_VIEWS, PCRLv2.n_levels) for _ in range(40)])
    assert drawn.shape == (40, 1 + 2 * N_VIEWS)
    assert set(drawn.flatten().tolist()) == set(range(5))
    assert LOSS_GUARD[2] is None
    model = PCRLv2(policy=PARITY_POLICY, device="cpu", seed=3)
    tstate = TrainState(model)
    views = {k: torch.from_numpy(v) for k, v in _views(1, b=2, size=32, local=32).items()}
    raw_next = {"image": torch.randint(0, 256, (2, 48, 48, 1), dtype=torch.uint8,
                                       generator=torch.Generator().manual_seed(2))}
    aug_fn = make_chest_aug_fn(n_local=N_VIEWS, global_size=32, local_size=32)
    gens = [torch.Generator().manual_seed(s) for s in (4, 5)]
    lr, epoch = torch.tensor(1e-3, dtype=torch.float32), torch.tensor(20)

    def host_read(*_):
        raise AssertionError("the 2D pipelined step read a tensor back to the host")

    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
            mp.setattr(torch.Tensor, name, host_read)
        m, next_views = pipelined_train_step(tstate, views, raw_next, *gens, lr, epoch,
                                             aug_fn=aug_fn, loss_guard=LOSS_GUARD[2])
    assert {k: next_views[k].shape for k in views} == {k: v.shape for k, v in views.items()}
    assert 0 <= int(m["level"]) < 5 and m["skipped"].item() == 0.0
    params, bufs, step = _snapshot(tstate)
    bad = dict(views, x1=views["x1"].clone())
    bad["x1"][0, 3, 4, 2] = float("nan")
    m = train_step(tstate, bad, [4, 3, 2, 1, 0], 1e-3, 20, loss_guard=LOSS_GUARD[2])
    assert m["skipped"].item() == 1.0 and not torch.isfinite(m["loss"]).item()
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for a, b in zip(tstate.optimizer.buffers, bufs):
        assert torch.equal(a, b)
    assert torch.equal(tstate.step, step)
    big = dict(views, gt=views["gt"] * 1e3)
    m = train_step(tstate, big, [4, 3, 2, 1, 0], 1e-3, 20, loss_guard=LOSS_GUARD[2])
    assert m["loss"].item() > 1000.0 and m["skipped"].item() == 0.0
    assert tstate.step.item() == 2


def test_encoder_pt_round_trips_with_jax(weights, tmp_path):
    """The 2D ``.pt`` (encoder only, torchvision names): JAX's export loads
    strictly into the port's ``ResNet18Encoder``, and the port's export into
    JAX's ``import_resnet18_encoder``, tensors exact; a bare torchvision
    state_dict with ``fc`` loads too."""
    enc = {"params": weights["params"]["encoder"],
           "batch_stats": weights["batch_stats"]["encoder"]}
    jpath = os.path.join(tmp_path, "jax.pt")
    jax_ckpt.export_resnet18_encoder(enc, jpath, epoch=3)
    encoder = ResNet18Encoder(device="cpu", seed=4)
    assert ckpt.import_resnet18_encoder(jpath, encoder)["epoch"] == 3
    want = ckpt.from_jax_variables(jax.device_get(enc), mapping=ckpt.resnet18_encoder_mapping())
    for k, v in encoder.state_dict().items():
        assert torch.equal(v, want[k]), k
    tpath = os.path.join(tmp_path, "port.pt")
    trained = PCRLv2(device="cpu", seed=2)
    ckpt.export_resnet18_encoder(trained.encoder, tpath, opt={"b": 2}, epoch=0)
    variables, raw = jax_ckpt.import_resnet18_encoder(tpath)
    assert raw["opt"] == {"b": 2}
    got = ckpt.from_jax_variables(jax.device_get(variables),
                                  mapping=ckpt.resnet18_encoder_mapping())
    for k, v in trained.encoder.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, got[k]), k
    bare = dict(trained.encoder.state_dict(), **{"fc.weight": torch.zeros(1000, 512),
                                                 "fc.bias": torch.zeros(1000)})
    torch.save(bare, os.path.join(tmp_path, "resnet18.pt"))
    fresh = ResNet18Encoder(device="cpu", seed=5)
    ckpt.import_resnet18_encoder(os.path.join(tmp_path, "resnet18.pt"), fresh)
    for k, v in trained.encoder.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k


# ---------------------------------------------------------------------------
# the 2D ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,stride,ci,co,bias", [(7, 2, 3, 64, False), (3, 1, 16, 8, True),
                                                 (3, 2, 8, 16, False), (1, 2, 8, 16, False)])
def test_conv2d_matches_jax(k, stride, ci, co, bias):
    """``conv2d`` against ``pcrlv2_tpu/ops/convolution.py::conv2d``, padding
    k//2, within 1e-5 of the output's largest entry (f32, other sum order)."""
    rng = np.random.RandomState(k + stride)
    x = rng.randn(2, 18, 22, ci).astype(np.float32)
    w = rng.randn(co, ci, k, k).astype(np.float32)
    b = rng.randn(co).astype(np.float32) if bias else None
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                                   None if b is None else jnp.asarray(b), stride=stride))
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w),
                 None if b is None else torch.from_numpy(b), stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_max_pool2d_with_ties_matches_jax():
    """3×3 stride-2 pad-1 max pool on a ReLU'd input full of ties (zeros and
    repeated values): forward and gradient exactly as JAX's ``reduce_window``
    and its VJP (the gradient to the first max of each window; the windows
    overlap, so inputs sum the gradients of several)."""
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randint(-3, 3, (2, 13, 10, 4)), 0).astype(np.float32)
    g = rng.randn(2, 7, 5, 4).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jpool.max_pool2d(t, window=3, stride=2, padding=1),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = max_pool2d(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))


def test_upsample_nearest_and_edge_blur_match_jax():
    """×2 nearest upsample and its gradient exactly; the edge-padded blur
    (17 taps, σ 0.1-2 per image, each axis) within 1e-6."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    g = rng.randn(2, 10, 14, 3).astype(np.float32)
    want, vjp = jax.vjp(jresize.upsample_nearest2x_2d, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = upsample_nearest2x_2d(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    img = rng.rand(3, 2, 20, 11).astype(np.float32)
    sigmas = np.array([0.1, 0.9, 2.0], np.float32)
    kern = blur.gaussian_kernel(torch.from_numpy(sigmas))
    jax_blur = jax.jit(lambda im, s, axis: jblur.blur_axis(im, jblur.gaussian_kernel(s), axis,
                                                           "edge"), static_argnums=2)
    for axis in (1, 2):
        got = blur.blur_axis(torch.from_numpy(img), kern, axis, "edge").numpy()
        for i, s in enumerate(sigmas):
            want = jax_blur(jnp.asarray(img[i]), s, axis)
            np.testing.assert_allclose(got[i], np.asarray(want), rtol=0, atol=1e-6)
