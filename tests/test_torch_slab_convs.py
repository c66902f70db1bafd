"""The slab template's kernels' geometry and K walk (packed #6, im2col #5,
and the td-outer im2col order of the prototype tool's CONCAT9, #7), the
padded-channel route of every 3³ conv kernel, and ``PCRLv23d`` with
``in_channels`` other than 1 against the JAX package.

No card here: the CUDA kernels run only on one (``chip_smoke.py`` holds them
to their plain versions there).  What the CPU can hold is the arithmetic
they are built on: ``_emulate`` below walks a block exactly as
``csrc/slab_conv.cuh`` does (row table, slab, the 9 tap offsets into it,
stages, K splits, the partials added in split order) and must equal the
plain versions; the tiling must cover every output voxel and every K index
once at every launch shape of a training step.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.core.precision import PARITY_POLICY as JAX_PARITY_POLICY
from pcrlv2_tpu.core.precision import Policy as JaxPolicy
from pcrlv2_tpu.models import PCRLv23d as JaxPCRLv23d
from pcrlv2_tpu.train import checkpoint as jax_ckpt

from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.ops import conv3d_kernel as ck
from pcrlv2_tpu_torch.ops import conv3d_packed as cp
from pcrlv2_tpu_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (several share a host), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the template's three modes: packed, im2col (also CONCAT27) and im2col
# walked td outer (CONCAT9)
KINDS = ("conv3d_packed", "conv3d_im2col", "proto_conv9")
DTYPES = (torch.float32, torch.bfloat16)
SMS = 132  # the H100's SMs

# The model's 3³ convs with Co > 1 as (Ci, Co, level) and the two calls of a
# training step at batch 4 (chip_smoke.py's CONVS and CALLS).
MODEL_CONVS = [(1, 32, 0), (32, 64, 0), (64, 64, 1), (64, 128, 1), (128, 128, 2),
               (128, 256, 2), (256, 256, 3), (256, 512, 3), (512, 256, 2), (256, 256, 2),
               (256, 128, 1), (128, 128, 1), (128, 64, 0), (64, 64, 0)]
MODEL_CALLS = [(4, (64, 64, 32)), (24, (16, 16, 16))]
# (B, D, H, W, Ci, Co) the CPU tests of the kernels use (odd W, W = 1,
# planes of 1..70 voxels, Ci and Co off the vector width)
TEST_SHAPES = [(2, 3, 5, 3, 4, 70), (1, 2, 70, 1, 17, 3), (3, 2, 2, 2, 8, 4),
               (2, 4, 6, 4, 3, 5), (1, 4, 4, 5, 1, 8), (1, 3, 7, 9, 2, 5), (1, 1, 1, 1, 3, 5)]


def _launches():
    """(B, D, H, W, Ci, Co) of every packed/im2col launch of a training step
    (forwards; dx swaps Ci and Co, the stem has none), then TEST_SHAPES."""
    out = []
    for b, size in MODEL_CALLS:
        for ci, co, level in MODEL_CONVS:
            shp = (b,) + tuple(s >> level for s in size)
            out.append(shp + (ci, co))
            if ci > 1:
                out.append(shp + (co, ci))
    return out + TEST_SHAPES


def _rand(seed, *shape, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernels' block walk, in numpy/torch (mirrors csrc/slab_conv.cuh)
# ---------------------------------------------------------------------------


def _origin(geo, t):
    if geo["P"] == 1:
        return t // geo["tpp"], (t % geo["tpp"]) * geo["L"]
    return t * geo["P"], 0


def _table(kind, geo, shape, t):
    """``build_table``: per slab row, (voxel, d, w) of its source, or voxel -1."""
    b, d, h, w = shape
    hw = h * w
    plane0, p0 = _origin(geo, t)
    j = np.arange(cp.slab_rows(kind, geo, w))
    if cp.MODE[kind] == "packed":
        seg = geo["L"] + 2 * w
        s, p = j // seg, p0 - w + j % seg
        ok = (p >= 0) & (p < hw)
        hh, ww = np.where(ok, p // w, 0), np.where(ok, p % w, 0)
    else:
        w2 = w + 2
        rw = geo["rows"] * w2
        s, rr, ww = j // rw, (j % rw) // w2, j % w2 - 1
        hh = p0 // w - 1 + rr
        ok = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
    plane = plane0 + s
    ok &= plane < b * d
    return np.where(ok, plane * hw + hh * w + ww, -1), plane % d, ww


def _out_rows(kind, geo, shape, t):
    """``out_row`` for the ``_BM`` rows of block ``t`` (an int or an array
    of blocks, one row each): (slab row of tap (0, 0) or -1, output voxel)."""
    b, d, h, w = shape
    hw = h * w
    t = np.asarray(t)[..., None]
    plane0, p0 = _origin(geo, t)
    r = np.arange(cp._BM)
    s, q = r // geo["L"], r % geo["L"]
    plane, p = plane0 + s, p0 + q
    ok = (s < geo["P"]) & (plane < b * d) & (p < hw)
    if cp.MODE[kind] == "packed":
        row = s * (geo["L"] + 2 * w) + q
    else:
        row = (s * geo["rows"] + p // w - p0 // w) * (w + 2) + p % w
    return np.where(ok, row, -1), plane * hw + p


def _slab(kind, tab, xf, shape, td, c0, bk):
    """One stage's slab: rows × (3·bk packed, bk im2col), zero where the
    kernel's copy is zero-filled."""
    vox, dd, ww = tab
    b, d, h, w = shape
    ci = xf.shape[1]
    shifts = (-1, 0, 1) if cp.MODE[kind] == "packed" else (0,)
    cols = []
    for sh in shifts:
        ok = (vox >= 0) & (dd + td - 1 >= 0) & (dd + td - 1 < d) & (ww + sh >= 0) & (ww + sh < w)
        src = np.where(ok, vox + (td - 1) * h * w + sh, 0)
        block = torch.zeros(len(vox), bk)
        n = min(bk, ci - c0)
        block[:, :n] = xf[src, c0:c0 + n] * torch.from_numpy(ok)[:, None]
        cols.append(block)
    return torch.cat(cols, 1)


def _emulate(kind, x, wmat, bias, dtype=torch.float32, splits=None):
    """The kernel's output in f32: per block, per K split, per stage the
    slab and the 9 tap products at the kernel's row offsets; the splits'
    partials added in order, then the bias.  ``dtype`` picks the chunk
    depth (BK) of that dtype's kernel; ``splits`` forces (S, per)."""
    b, d, h, w, ci = x.shape
    co = wmat.shape[-1]
    shape = (b, d, h, w)
    bk = cp._SLAB[dtype][0]
    geo = cp.tiles(b, d, h, w)
    walk = cp.stages(kind, ci, dtype)
    bn = ck.fwd_tile(ci, co)
    s, per = splits or cp.split(geo["tiles"] * math.ceil(co / bn), len(walk), SMS)
    xf = x.reshape(-1, ci).float()
    wk = torch.zeros(27, ci + bk, co)
    wk[:, :ci] = wmat.float()
    out = torch.zeros(b * d * h * w, co)
    for t in range(geo["tiles"]):
        tab = _table(kind, geo, shape, t)
        rows, vox = _out_rows(kind, geo, shape, t)
        base = np.maximum(rows, 0)
        total = torch.zeros(cp._BM, co)
        for z in range(s):
            acc = torch.zeros(cp._BM, co)
            for td, c0 in walk[z * per:(z + 1) * per]:
                slab = _slab(kind, tab, xf, shape, td, c0, bk)
                for tap in range(9):
                    th, tw = divmod(tap, 3)
                    if cp.MODE[kind] == "packed":
                        a = slab[base + th * w, tw * bk:(tw + 1) * bk]
                    else:
                        a = slab[base + th * (w + 2) + tw]
                    acc += a @ wk[9 * td + tap, c0:c0 + bk]
            total = total + acc
        if bias is not None:
            total = total + bias.float()
        ok = rows >= 0
        out[vox[ok]] = total[torch.from_numpy(ok)]
    return out.reshape(b, d, h, w, co)


# ---------------------------------------------------------------------------
# geometry at every launch shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,d,h,w,ci,co", _launches())
def test_blocks_cover_every_voxel_and_k_index_once(b, d, h, w, ci, co):
    """At each launch shape of a step and each test shape: every output
    voxel is one row of one block; every slab row a valid output row reads
    (all 9 taps) lies in the slab and holds the voxel the tap needs; the K
    splits walk every (tap, channel) once; one block fits the card's shared
    memory in both dtypes."""
    shape = (b, d, h, w)
    geo = cp.tiles(*shape)
    for kind in KINDS:
        rows, vox = _out_rows(kind, geo, shape, np.arange(geo["tiles"]))
        hits = np.bincount(vox[rows >= 0], minlength=b * d * h * w)
        # the first two blocks, one in the middle and the last: each tap of
        # each valid row reads the slab row (and packed column block) that
        # holds the voxel it needs, or a zero row outside the plane
        for t in sorted({0, min(1, geo["tiles"] - 1), geo["tiles"] // 2, geo["tiles"] - 1}):
            rows_t, vox_t = rows[t], vox[t]
            ok = rows_t >= 0
            tvox, _, tw_of = _table(kind, geo, shape, t)
            vd, rem = np.divmod(vox_t[ok], h * w)
            vh, vw = np.divmod(rem, w)
            for th in range(3):
                for tw in range(3):
                    if cp.MODE[kind] == "packed":
                        j = rows_t[ok] + th * w
                        src = np.where((tvox[j] >= 0) & (tw_of[j] + tw - 1 >= 0)
                                       & (tw_of[j] + tw - 1 < w), tvox[j] + tw - 1, -1)
                    else:
                        src = tvox[rows_t[ok] + th * (w + 2) + tw]
                    sh, sw = vh + th - 1, vw + tw - 1
                    inside = (sh >= 0) & (sh < h) & (sw >= 0) & (sw < w)
                    want = np.where(inside, vd * h * w + sh * w + sw, -1)
                    assert (src == want).all(), (kind, t, th, tw)
        assert (hits == 1).all(), kind
        for dtype in DTYPES:
            ci_p, co_p = ck.vector_channels(ci, co, dtype, stem=False)
            bn = ck.fwd_tile(ci_p, co_p)
            assert cp.smem_bytes(kind, geo, w, bn, dtype) <= cp.SMEM_LIMIT, (kind, dtype)
            walk = cp.stages(kind, ci_p, dtype)
            s, per = cp.split(geo["tiles"] * math.ceil(co_p / bn), len(walk), SMS)
            assert 1 <= s and (s - 1) * per < len(walk) <= s * per
            covered = np.zeros(27 * ci_p, np.int64)
            bk = cp._SLAB[dtype][0]
            for td, c0 in walk:
                for tap in range(9 * td, 9 * td + 9):
                    covered[tap * ci_p + c0:tap * ci_p + min(c0 + bk, ci_p)] += 1
            assert (covered == 1).all()
            if geo["tiles"] * math.ceil(co_p / bn) >= 2 * SMS:
                assert s == 1


# ---------------------------------------------------------------------------
# the block walk against the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,dtype,splits", [
    ((2, 3, 5, 3, 4, 70), torch.float32, None),
    ((1, 2, 70, 1, 16, 8), torch.float32, (3, 2)),
    ((1, 2, 16, 12, 24, 8), torch.float32, (2, 5)),
    ((3, 2, 2, 2, 8, 4), torch.bfloat16, (3, 1)),
    ((1, 3, 7, 9, 2, 5), torch.float32, None),
    ((2, 2, 9, 16, 32, 4), torch.bfloat16, (3, 2)),
])
def test_block_walk_equals_plain(kind, shape, dtype, splits):
    """The kernel's blocked, split order (``_emulate``) on the operands the
    wrapper launches it with (channels padded as ``route`` says) equals the
    plain version in f32: the same products summed in another order, 1e-5
    of the largest entry.  Shapes cross a band's ragged end, W = 1, odd W,
    several small planes a block and the bf16 chunk depth."""
    b, d, h, w, ci, co = shape
    x = torch.from_numpy(_rand(30, b, d, h, w, ci))
    wm = torch.from_numpy(_rand(31, 27, ci, co, scale=0.2))
    bias = torch.from_numpy(_rand(32, co))
    plain = cp.conv3d_packed_plain if cp.MODE[kind] == "packed" else cp.conv3d_im2col_plain
    want = plain(x, wm, bias)
    ci_p, co_p = ck.vector_channels(ci, co, dtype, stem=False)
    xp, wp, bp = ck.padded_operands(x, wm, bias, ci_p, co_p)
    got = _emulate(kind, xp, wp, bp, dtype, splits)[..., :co]
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), (kind, err)


# ---------------------------------------------------------------------------
# routes and the padded channels of #1 and #2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ci,co,dtype,fwd_route,slab_route", [
    (1, 32, torch.bfloat16, "stem", "padded"),
    (1, 32, torch.float32, "stem", "padded"),
    (32, 64, torch.bfloat16, "vector", "vector"),
    (512, 256, torch.float32, "vector", "vector"),
    (12, 8, torch.float32, "vector", "vector"),
    (12, 8, torch.bfloat16, "padded", "padded"),
    (2, 32, torch.float32, "padded", "padded"),
    (3, 5, torch.bfloat16, "padded", "padded"),
    (17, 70, torch.float32, "padded", "padded"),
    (8, 70, torch.bfloat16, "padded", "padded"),
    (1, 5, torch.float32, "stem", "padded"),
])
def test_routes(ci, co, dtype, fwd_route, slab_route):
    """#1/#2 keep the stem kernels for Ci = 1 and run every other shape the
    16-byte copies cannot take on zero-padded channels; #5/#6 have no stem
    kernel, so Ci = 1 is padded too.  The main path's shapes all take
    ``vector`` but the stem's."""
    assert ck.route(ci, co, dtype) == fwd_route
    assert cp.route(ci, co, dtype) == slab_route
    ci_p, co_p = ck.vector_channels(ci, co, dtype)
    vec = ck._VEC[dtype]
    assert (ci_p == 1 or ci_p % vec == 0) and co_p % vec == 0
    assert ci <= ci_p < ci + vec and co <= co_p < co + vec
    if fwd_route == "vector":
        assert (ci_p, co_p) == (ci, co)
    for c, o, _ in MODEL_CONVS:
        assert ck.route(c, o, dtype) == ("stem" if c == 1 else "vector")
        assert cp.route(c, o, dtype) == ("padded" if c == 1 else "vector")
        if c > 1:  # dx: Ci and Co swapped
            assert ck.route(o, c, dtype) == cp.route(o, c, dtype) == "vector"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ci,co", [(2, 32), (3, 5), (17, 70), (1, 5)])
def test_padded_route_equals_plain(dtype, ci, co):
    """The launches #1 and #2 make on padded channels, with their plain
    versions in the kernels' place: forward, dx (Ci and Co swapped) and the
    filter grad, sliced back, equal the plain versions on the unpadded
    tensors: zero channels add exact zeros, but a wider product may sum in
    another order (BLAS blocking), so within 1e-6 of the largest entry."""

    def same(got, want):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-6 * want.float().abs().max().item(), err

    b, d, h, w = 2, 3, 4, 5
    x = torch.from_numpy(_rand(40, b, d, h, w, ci)).to(dtype)
    g = torch.from_numpy(_rand(41, b, d, h, w, co)).to(dtype)
    wm = torch.from_numpy(_rand(42, 27, ci, co, scale=0.2)).to(dtype)
    bias = torch.from_numpy(_rand(43, co)).to(dtype)
    ci_p, co_p = ck.vector_channels(ci, co, dtype)
    xp, wp, bp = ck.padded_operands(x, wm, bias, ci_p, co_p)
    assert xp.shape[-1] == ci_p and wp.shape == (27, ci_p, co_p) and bp.shape == (co_p,)
    got = ck.conv3d_fwd_plain(xp, wp, bp)[..., :co]
    same(got, ck.conv3d_fwd_plain(x, wm, bias))
    wt = ck.flipped_weight(ck.unpack_weight_grad(wm.float()), dtype)  # (27, Co, Ci)
    gp, wtp, _ = ck.padded_operands(g, wt, None, *ck.vector_channels(co, ci, dtype))
    got = ck.conv3d_fwd_plain(gp, wtp, None)[..., :ci]
    same(got, ck.conv3d_fwd_plain(g, wt, None))
    xq, gq = ck.pad_last(x, ci_p), ck.pad_last(g, co_p)
    got = ck.conv3d_dw_plain(xq, gq)[:, :ci, :co]
    same(got, ck.conv3d_dw_plain(x, g))


# ---------------------------------------------------------------------------
# PCRLv23d(in_channels=c) against the JAX package
# ---------------------------------------------------------------------------


#: biases that feed a BatchNorm: their true gradient is 0 and both sides
#: hold rounding noise (as tests/test_torch_model.py)
_FEED_BN = ("conv1.bias", "predictor_head.0.bias", ".bn.bias")


@pytest.mark.parametrize("in_channels", [2, 3])
def test_model_with_in_channels_matches_jax(in_channels):
    """``PCRLv23d(in_channels=c)`` on the JAX model's weights
    (``from_jax_variables``): the train-mode forward (output and masks)
    within the model test's ``FWD_TOL`` of JAX's f32 forward, and the
    gradient of mean(out²) + Σ mean(mask²) for every parameter and for the
    input within 2e-3 of each tensor's largest entry of a float64 JAX run,
    the bound ``test_gradient_matches_jax_float64`` holds the port to."""
    x = np.random.RandomState(50 + in_channels).rand(2, 16, 16, 8, in_channels).astype(np.float32)
    jmodel = JaxPCRLv23d(policy=JAX_PARITY_POLICY, in_channels=in_channels)
    # weights drawn by the port (JAX's own init costs seconds to compile),
    # carried to JAX by the JAX package's converter and back
    drawn = PCRLv23d(policy=PARITY_POLICY, in_channels=in_channels, seed=in_channels,
                     device="cpu").state_dict()
    variables = jax.tree.map(np.asarray, jax_ckpt.torch_state_to_flax(
        drawn, jax_ckpt.pcrlv23d_mapping()))
    (jout, _, jmasks), _ = jax.jit(lambda v, xs: jmodel.apply(
        v, xs, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))

    f64 = JaxPolicy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
                    output_dtype=jnp.float64)
    jmodel64 = JaxPCRLv23d(policy=f64, in_channels=in_channels)

    def jloss(params, stats, v):
        (out, _, masks), _ = jmodel64.apply({"params": params, "batch_stats": stats}, v,
                                            train=True, mutable=["batch_stats"])
        return jnp.mean(out ** 2) + sum(jnp.mean(m ** 2) for m in masks)

    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        gparams, gx = jax.jit(jax.grad(jloss, argnums=(0, 2)))(
            to64(variables["params"]), to64(variables["batch_stats"]),
            jnp.asarray(x, jnp.float64))
        want = ckpt.from_jax_variables({"params": jax.tree.map(np.asarray, gparams),
                                        "batch_stats": variables["batch_stats"]})
        gx = np.asarray(gx)

    model = PCRLv23d(policy=PARITY_POLICY, in_channels=in_channels, device="cpu")
    model.load_state_dict(ckpt.from_jax_variables(variables), strict=True)
    model.train()
    xt = torch.from_numpy(x).requires_grad_()
    out, _, masks = model(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    for m, jm in zip(masks, jmasks):
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm), rtol=1e-4, atol=1e-5)
    loss = out.square().mean() + sum(m.square().mean() for m in masks)
    loss.backward()
    err = np.abs(xt.grad.double().numpy() - gx).max()
    assert err <= 2e-3 * np.abs(gx).max(), ("input", err)
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        if p.grad is None:
            np.testing.assert_array_equal(ref, 0, err_msg=name)
            continue
        if name.endswith(_FEED_BN):
            continue
        err = np.abs(p.grad.double().numpy() - ref).max()
        assert err <= 2e-3 * np.abs(ref).max(), (name, err, np.abs(ref).max())
