"""The port's kernel prototype tools (kernels #7-#10, their plain versions on
the CPU) against the JAX tools in ``tools/`` run in interpret mode.

``tools/`` is no package, so the JAX tools are loaded by file path.  Inputs
come from ``np.random.default_rng``; the same arrays go into both packages in
the JAX tools' layouts (x NDHWC, w DHWIO).  The CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``
phase 9.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pcrlv2_tpu_torch.tools import probe_mosaic as pm
from pcrlv2_tpu_torch.tools import proto_co1_kernel as co
from pcrlv2_tpu_torch.tools import proto_conv as pc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_pc = _load_jax_tool("proto_conv")
jax_co = _load_jax_tool("proto_co1_kernel")

# f32 on both sides, sums in another order: ~1e-6 of the largest entry.
# bf16: the outputs are rounded once (2^-8), and the JAX stencil also rounds
# each product to bf16 before widening it (the port multiplies in f32).
TOL = {np.float32: 1e-4, jnp.bfloat16: 1.6e-2}
TORCH = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])


def _assert_close_to_max(got, want, tol, name):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("mode", ["27", "9"])
@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 6, 4, 3, 5), np.float32),
    ((1, 4, 4, 5, 1, 8), np.float32),     # Ci = 1, odd W
    ((2, 3, 4, 6, 4, 1), np.float32),     # Co = 1
    ((2, 4, 6, 4, 3, 5), jnp.bfloat16),
])
def test_proto_conv_matches_jax(mode, shape, dtype):
    """#7 in both modes against the JAX tool's ``conv3d_im2col``."""
    b, d, h, w, ci, co_ = shape
    rng = np.random.default_rng(7)
    xj, xt = _both(_rand(rng, b, d, h, w, ci), dtype)
    wj, wt = _both(_rand(rng, 3, 3, 3, ci, co_, scale=0.2), dtype)
    bj, bt = _both(_rand(rng, co_), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pc.conv3d_im2col(xj, wj, bj, mode=mode)
    got = pc.conv3d_im2col(xt, wt, bt, mode=mode)
    assert got.dtype == TORCH[dtype]
    _assert_close_to_max(got, want, TOL[dtype], f"conv{mode} {shape}")


@pytest.mark.parametrize("form", ["stencil", "band"])
@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 6, 4, 8), np.float32),
    ((1, 3, 5, 7, 3), np.float32),        # odd W
    ((2, 4, 6, 4, 8), jnp.bfloat16),
])
def test_co1_matches_jax(form, shape, dtype):
    """#8 against ``conv3d_co1_fwd`` and #9 against ``conv3d_co1_band``."""
    jax_fn = {"stencil": jax_co.conv3d_co1_fwd, "band": jax_co.conv3d_co1_band}[form]
    port_fn = {"stencil": co.conv3d_co1_fwd, "band": co.conv3d_co1_band}[form]
    rng = np.random.default_rng(8)
    xj, xt = _both(_rand(rng, *shape), dtype)
    wj, wt = _both(_rand(rng, 3, 3, 3, shape[-1], 1, scale=0.2), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, wj)
    got = port_fn(xt, wt)
    assert got.dtype == TORCH[dtype]
    _assert_close_to_max(got, want, TOL[dtype], f"co1 {form} {shape}")


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_band_mats_match_jax_bit_for_bit(dtype):
    """Each band entry is one weight or zero, so the two agree exactly."""
    wj, wt = _both(_rand(np.random.default_rng(9), 3, 3, 3, 4, 1), dtype)
    want = np.asarray(jax_co._band_mats(wj, 5))
    got = co.band_mats(wt, 5)
    assert tuple(got.shape) == want.shape == (9, 7 * 4, 5)
    bits = {np.float32: (torch.int32, np.int32), jnp.bfloat16: (torch.int16, np.int16)}
    tbits, nbits = bits[dtype]
    np.testing.assert_array_equal(got.view(tbits).numpy(), want.view(nbits))


@pytest.fixture(scope="module")
def jax_probes():
    """Each probe's output from the JAX tool's own ``main()`` in interpret
    mode: its ``probe`` reporter is swapped for one that keeps the value."""
    mod = _load_jax_tool("probe_mosaic")
    outs = {}
    mod.probe = lambda name, fn: outs.__setitem__(name, np.asarray(fn()))
    with pltpu.force_tpu_interpret_mode():
        mod.main()
    return outs


@pytest.mark.parametrize("name", list(pm.PLAIN))
def test_probe_matches_jax_bit_for_bit(name, jax_probes):
    """#10: each of the 14 probes through ``run`` (its plain version on CPU
    tensors) against the JAX tool's ``run`` on the same inputs."""
    (_, out_shape, xs), = [p for p in pm.probes("cpu") if p[0] == name]
    got = pm.run(name, out_shape, *xs)
    want = jax_probes[name]
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.view(torch.int32).numpy(), want.view(np.int32))


def test_probe_launch_table_matches_per_call_derivation():
    """#10's launch table, worked out once per input shapes (``plan``): for
    each of the 14 probes the first input viewed as (n0, n1), n2 the second
    input's last dimension (0 without one), the probe's number and the
    output's shape and dtype, as ``run`` derived them on every call before;
    a wrong ``out_shape`` still raises, and ``floor`` runs on the card only."""
    for i, (name, out_shape, xs) in enumerate(pm.probes("cpu")):
        p = pm.plan(name, tuple((x.shape, x.dtype) for x in xs))
        n0 = xs[0].shape[0]
        assert (p.n0, p.n1, p.n2) == (n0, xs[0].numel() // n0,
                                      xs[1].shape[-1] if len(xs) > 1 else 0)
        want = pm.plain(name, *xs)
        assert p.out == out_shape == (tuple(want.shape), want.dtype)
        assert p.index == i
        with pytest.raises(ValueError, match="gives"):
            pm.run(name, ((1,), out_shape[1]), *xs)
        with pytest.raises(RuntimeError, match="card"):
            pm.floor(name, out_shape, *xs)


@pytest.mark.parametrize("which", ["conv27", "conv9", "co1", "band"])
def test_chunked_plain_equals_unchunked(which):
    """The plain versions run a sample at a time on the card (the whole
    batch's windows would not fit); that gives the same values."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_rand(rng, 3, 4, 5, 6, 4))
    w = torch.from_numpy(_rand(rng, 3, 3, 3, 4, 5, scale=0.2))
    bias = torch.from_numpy(_rand(rng, 5))
    if which.startswith("conv"):
        fn = lambda chunk: pc.conv_plain(x, w.reshape(27 * 4, 5), bias, which[4:], chunk)  # noqa: E731
    elif which == "co1":
        fn = lambda chunk: co.co1_plain(x, w[..., 0].reshape(27, 4), chunk)  # noqa: E731
    else:
        fn = lambda chunk: co.band_plain(x, co.band_mats(w[..., :1], 6), chunk)  # noqa: E731
    whole = fn(None)
    for chunk in (1, 2):
        torch.testing.assert_close(fn(chunk), whole, rtol=0, atol=0)


TOOLS = {
    "proto_conv": lambda device: pc.main(device, batch=1, dtype=torch.float32,
                                         shapes=[(3, 4, 5, 2, 3)]),
    "proto_co1_kernel.main": lambda device: co.main(device, batch=1, dtype=torch.float32,
                                                    shapes=[(3, 4, 5, 2)]),
    "proto_co1_kernel.main2": lambda device: co.main2(device, batch=1, dtype=torch.float32,
                                                      shapes=[(3, 4, 5, 2)]),
    "probe_mosaic": pm.main,
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_main_needs_cuda_unless_cpu_is_asked(tool, monkeypatch):
    """Without CUDA a tool's ``main()`` raises; with ``device="cpu"`` it runs
    the plain versions, which agree with themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOOLS[tool](None)
    result = TOOLS[tool]("cpu")
    if tool == "probe_mosaic":
        assert result == 0
    else:
        assert result and all(r["rel_err"] == 0 and r["ms"] is None for r in result)
