"""The port's packed and im2col 3³ convs (kernels #5 and #6, their plain
versions on the CPU) against the JAX package's ``conv3d_packed`` and
``conv3d_im2col`` run in interpret mode, the ``PCRL_CONV3D`` selector, and
the model under each selector against the default on the same weights.

JAX's ``conv3d()`` dispatches these kernels only on a TPU, so they are
called directly under ``pltpu.force_tpu_interpret_mode()``.  The CUDA
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pcrlv2_tpu.ops.pallas_conv import conv3d_im2col as jax_conv3d_im2col
from pcrlv2_tpu.ops.pallas_conv import conv3d_packed as jax_conv3d_packed

from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.ops import conv3d_kernel as ck
from pcrlv2_tpu_torch.ops import conv3d_packed as cp
from pcrlv2_tpu_torch.ops import convolution


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _to_torch_w(w_dhwio):
    """(3, 3, 3, Ci, Co) → (Co, Ci, 3, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_dhwio, (4, 3, 0, 1, 2))))


def _assert_close_to_max(got, want, tol, name):
    """|got − want| ≤ tol · max|want|: f32 on both sides, sums in another
    order (per-tap or per-packed-block products against Pallas's), which
    moves each entry by ~1e-6 of the largest; 1e-4 leaves room for the
    filter gradient's sum over every voxel."""
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    scale = np.abs(np.asarray(want)).max()
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("variant", ["packed", "im2col"])
@pytest.mark.parametrize("shape", [(2, 4, 6, 4, 3, 5), (1, 4, 4, 5, 1, 8)])
def test_forward_and_gradients_match_jax(variant, shape):
    """Forward, dx, dw and db of the loss Σ(conv·g) against the JAX custom
    VJP; the second shape is the Ci = 1 stem with an odd W."""
    jax_fn = {"packed": jax_conv3d_packed, "im2col": jax_conv3d_im2col}[variant]
    port_fn = {"packed": cp.conv3d_packed, "im2col": cp.conv3d_im2col}[variant]
    b, d, h, w, ci, co = shape
    x, wt, bias = _rand(1, b, d, h, w, ci), _rand(2, 3, 3, 3, ci, co, scale=0.2), _rand(3, co)
    g = _rand(4, b, d, h, w, co)

    def forward_and_grads(x_, w_, b_):
        out, vjp = jax.vjp(jax_fn, x_, w_, b_)
        # the gradient of Σ(conv·g): the VJP at cotangent g
        return (out,) + vjp(jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():  # one jitted program, not one per op
        want, gx, gw, gb = jax.jit(forward_and_grads)(
            jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    xt = torch.from_numpy(x).requires_grad_()
    wtt = _to_torch_w(wt).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    out = port_fn(xt, wtt, bt)
    (out * torch.from_numpy(g)).sum().backward()
    _assert_close_to_max(out.detach().numpy(), want, 1e-4, "forward")
    _assert_close_to_max(xt.grad.numpy(), gx, 1e-4, "dx")
    _assert_close_to_max(wtt.grad.numpy(), np.transpose(np.asarray(gw), (4, 3, 0, 1, 2)),
                         1e-4, "dw")
    _assert_close_to_max(bt.grad.numpy(), gb, 1e-4, "db")


@pytest.mark.parametrize("shape", [(2, 3, 5, 3, 4, 70), (1, 2, 70, 1, 17, 3),
                                   (3, 2, 2, 2, 8, 4)])
def test_plain_versions_match_the_implicit_gemm(shape):
    """The two plain versions against ``conv3d_fwd_plain`` in f32, at shapes
    that cross the kernels' tiling edges: Co over one 64-column tile, a
    plane of over 64 voxels with W = 1 and a ragged Ci chunk, planes of 4
    voxels.  Same products in another order: 1e-5 of the largest entry."""
    b, d, h, w, ci, co = shape
    x = torch.from_numpy(_rand(5, b, d, h, w, ci))
    wm = torch.from_numpy(_rand(6, 27, ci, co, scale=0.2))
    bias = torch.from_numpy(_rand(7, co))
    want = ck.conv3d_fwd_plain(x, wm, bias)
    for fn in (cp.conv3d_packed_fwd, cp.conv3d_im2col_fwd):
        _assert_close_to_max(fn(x, wm, bias).numpy(), want.numpy(), 1e-5, fn.__name__)


@pytest.mark.parametrize("b,d,h,w", [(4, 64, 64, 32), (24, 2, 2, 2), (4, 8, 8, 4),
                                     (1, 3, 7, 9), (2, 2, 70, 1), (1, 1, 1, 1)])
def test_tiles_cover_every_voxel_once(b, d, h, w):
    """The kernels' block geometry: each output voxel belongs to exactly one
    block row; the im2col slab's rows hold every row a block reads; the
    main-path shapes fit a block's shared memory in both dtypes at the
    widest tile (128 columns)."""
    geo = cp.tiles(b, d, h, w)
    hits = np.zeros(b * d * h * w, np.int64)
    for t in range(geo["tiles"]):
        plane0 = t // geo["tpp"] if geo["P"] == 1 else t * geo["P"]
        p0 = (t % geo["tpp"]) * geo["L"] if geo["P"] == 1 else 0
        for r in range(cp._BM):
            s, q = divmod(r, geo["L"])
            plane, p = plane0 + s, p0 + q
            if s < geo["P"] and plane < b * d and p < h * w:
                hits[plane * h * w + p] += 1
                assert p // w - p0 // w + 3 <= geo["rows"]
    assert (hits == 1).all()
    for kind in ("conv3d_packed", "conv3d_im2col"):
        for dtype in (torch.float32, torch.bfloat16):
            assert cp.smem_bytes(kind, geo, w, 128, dtype) <= cp.SMEM_LIMIT


def _spy(monkeypatch, calls):
    for mod, name in ((ck, "conv3d_fwd_plain"), (cp, "conv3d_packed_plain"),
                      (cp, "conv3d_im2col_plain")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("value,fwd,dx", [
    (None, "conv3d_fwd_plain", "conv3d_fwd_plain"),
    ("pallas", "conv3d_fwd_plain", "conv3d_fwd_plain"),
    ("packed", "conv3d_packed_plain", "conv3d_packed_plain"),
    ("IM2COL", "conv3d_im2col_plain", "conv3d_fwd_plain"),
])
def test_selector_dispatches_forward_and_dx(monkeypatch, value, fwd, dx):
    """``PCRL_CONV3D`` picks the forward and dx of every Co > 1 3³ conv (the
    CPU mirror of ``chip_smoke.py``'s launch counts), read at each call;
    Co = 1 heads keep the head kernel under every value."""
    if value is None:
        monkeypatch.delenv("PCRL_CONV3D", raising=False)
    else:
        monkeypatch.setenv("PCRL_CONV3D", value)
    calls = []
    _spy(monkeypatch, calls)
    x = torch.from_numpy(_rand(8, 1, 4, 4, 4, 3)).requires_grad_()
    w = torch.from_numpy(_rand(9, 5, 3, 3, 3, 3, scale=0.2))
    out = convolution.conv3d(x, w, torch.zeros(5))
    assert calls == [fwd]
    out.sum().backward()
    assert calls == [fwd, dx]
    calls.clear()
    convolution.conv3d(x, torch.from_numpy(_rand(10, 1, 3, 3, 3, 3)), torch.zeros(1))
    assert calls == []


@pytest.mark.parametrize("value", ["xla", "auto", "bogus"])
def test_selector_refuses_what_the_port_does_not_have(monkeypatch, value):
    monkeypatch.setenv("PCRL_CONV3D", value)
    with pytest.raises(ValueError, match="pallas"):
        convolution.conv_impl()
    with pytest.raises(ValueError, match="pallas"):
        convolution.conv3d(torch.zeros(1, 2, 2, 2, 3), torch.zeros(4, 3, 3, 3, 3))


@pytest.mark.parametrize("variant", ["packed", "im2col"])
def test_model_under_each_selector_matches_the_default(monkeypatch, variant):
    """The whole PCRLv23d at 16×16×8 (batch 2) on the same weights: output,
    masks and the gradient of their loss for every parameter under
    ``packed``/``im2col`` against ``pallas``.  Same products summed in
    another order per conv: 1e-4 of each tensor's largest entry.  The
    projection features stay out of the loss: their BatchNorm over 2
    samples turns 1e-6 differences into 1e-3 (``test_torch_model.py``).
    Every conv bias feeds a BatchNorm, whose mean subtraction cancels it:
    its true gradient is 0 and both sides hold rounding noise, so only
    its being there is checked."""
    x = torch.from_numpy(np.random.RandomState(11).rand(2, 16, 16, 8, 1).astype(np.float32))
    results = {}
    for impl in ("pallas", variant):
        monkeypatch.setenv("PCRL_CONV3D", impl)
        model = PCRLv23d(policy=PARITY_POLICY, seed=3, device="cpu")
        out, _, masks = model(x)
        loss = out.square().mean() + sum(m.square().mean() for m in masks)
        loss.backward()
        results[impl] = ([out.detach()] + [m.detach() for m in masks],
                         {n: p.grad for n, p in model.named_parameters()})
    (outs_a, grads_a), (outs_b, grads_b) = results["pallas"], results[variant]
    for a, b in zip(outs_a, outs_b):
        _assert_close_to_max(b.numpy(), a.numpy(), 1e-4, "output")
    assert grads_a.keys() == grads_b.keys()
    for name, ga in grads_a.items():
        if ga is None or name.endswith("conv1.bias"):
            assert (grads_b[name] is None) == (ga is None), name
            continue
        _assert_close_to_max(grads_b[name].numpy(), ga.numpy(), 1e-4, name)
