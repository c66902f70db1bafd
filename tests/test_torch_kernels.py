"""The plain versions of the port's four CUDA kernels held against the JAX
package's Pallas kernels (interpret mode on the CPU), forward and every
gradient, plus the wrappers' input checks and the shape dispatch.

On the CPU each wrapper runs its plain version; the CUDA kernels themselves
are held against the same plain versions on the card by ``chip_smoke.py``.
Tolerance 1e-4 in f32, as the JAX package's own kernel tests use.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from pcrlv2_tpu.ops.convolution import conv_transpose3d as jax_conv_transpose3d
from pcrlv2_tpu.ops.head_conv import conv3d_co1_tapmajor
from pcrlv2_tpu.ops.pallas_conv import conv3d_pallas

from pcrlv2_tpu_torch.ops import conv3d_kernel as ck
from pcrlv2_tpu_torch.ops import head_conv as hc
from pcrlv2_tpu_torch.ops.convolution import conv3d, conv_transpose3d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(seed, *shape, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _to_torch_w(w_dhwio):
    """(3, 3, 3, Ci, Co) → (Co, Ci, 3, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_dhwio, (4, 3, 0, 1, 2))))


def _lax_conv(x, w):
    return lax.conv_general_dilated(x, w, (1, 1, 1), [(1, 1)] * 3,
                                    dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


# (B, D, H, W, Ci, Co): the JAX kernel tests' shapes, the Ci=1 stem, and a
# W=1 plane like the local views' deepest stage
CONV_SHAPES = [(2, 8, 8, 8, 4, 8), (1, 16, 16, 8, 1, 16), (2, 4, 4, 4, 32, 16),
               (2, 2, 2, 1, 8, 24)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3d_forward_matches_pallas(shape):
    b, d, h, w, ci, co = shape
    x, wt, bias = _rand(0, b, d, h, w, ci), _rand(1, 3, 3, 3, ci, co, scale=0.1), _rand(2, co)
    with pltpu.force_tpu_interpret_mode():  # jitted: one compile, not one per op
        want = jax.jit(conv3d_pallas)(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    wm = ck.repack_weight(_to_torch_w(wt), torch.float32)
    got = ck.conv3d_fwd(torch.from_numpy(x), wm, torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(2, 4, 6, 4, 3, 5), (1, 4, 4, 4, 1, 8)])
def test_conv3d_gradients_match_pallas(shape):
    """dx (forward kernel on flipped weights), dw (filter-grad kernel) and db
    through the autograd Function, against ``conv3d_pallas``'s VJP."""
    b, d, h, w, ci, co = shape
    x, wt, bias = _rand(3, b, d, h, w, ci), _rand(4, 3, 3, 3, ci, co, scale=0.2), _rand(5, co)

    def loss(x_, w_, b_):
        return jnp.sum(conv3d_pallas(x_, w_, b_) ** 2)

    with pltpu.force_tpu_interpret_mode():  # jitted: one compile, not one per op
        gx, gw, gb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    xt = torch.from_numpy(x).requires_grad_()
    wtt = _to_torch_w(wt).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    (ck.conv3d(xt, wtt, bt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(wtt.grad.numpy(),
                               np.transpose(np.asarray(gw), (4, 3, 0, 1, 2)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", [(2, 6, 8, 4, 6), (1, 3, 32, 48, 4)])
def test_head_conv_matches_pallas(shape, monkeypatch):
    """Forward (#3) and fused backward (#4) against ``conv3d_co1_tapmajor``
    under ``PCRL_HEADCONV=tapP``; the second shape drives the JAX kernel's
    row banding."""
    monkeypatch.setenv("PCRL_HEADCONV", "tapP")
    b, d, h, w, ci = shape
    x, wt, g = _rand(7, b, d, h, w, ci), _rand(8, 3, 3, 3, ci, 1, scale=0.2), _rand(9, b, d, h, w, 1)

    def loss(x_, w_):
        return jnp.sum(conv3d_co1_tapmajor(x_, w_) * g)

    want = jax.jit(conv3d_co1_tapmajor)(jnp.asarray(x), jnp.asarray(wt))
    gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(wt))
    xt = torch.from_numpy(x).requires_grad_()
    wtt = _to_torch_w(wt).requires_grad_()
    out = hc.head_conv3d(xt, wtt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(wtt.grad.numpy(),
                               np.transpose(np.asarray(gw), (4, 3, 0, 1, 2)), **TOL)


def test_conv_dispatch_matches_lax():
    """ops.conv3d: Co=1 → head path (+bias), Co>1 → conv path, 1³ → matmul."""
    x = _rand(10, 2, 4, 6, 4, 5)
    for co, k in ((1, 3), (7, 3), (3, 1)):
        w = _rand(11, k, k, k, 5, co, scale=0.3)
        b = _rand(12, co)
        want = np.asarray(_lax_conv(jnp.asarray(x), jnp.asarray(w))) + b if k == 3 else \
            np.asarray(lax.conv_general_dilated(
                jnp.asarray(x), jnp.asarray(w), (1, 1, 1), [(0, 0)] * 3,
                dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))) + b
        got = conv3d(torch.from_numpy(x), _to_torch_w(w), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"co={co} k={k}")


def test_conv_transpose_matches_jax():
    x, w, b = _rand(13, 2, 3, 4, 2, 6), _rand(14, 2, 2, 2, 6, 5), _rand(15, 5)
    want = jax_conv_transpose3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    w_t = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 4, 0, 1, 2))))
    got = conv_transpose3d(torch.from_numpy(x), w_t, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bf16_plain_versions_accumulate_in_f32():
    """bf16 inputs: the plain versions widen to f32, accumulate, and round
    once at the end, so they sit within one bf16 rounding of the f32 result
    on the same (bf16-representable) inputs."""
    x = torch.from_numpy(_rand(16, 2, 4, 4, 4, 16)).bfloat16()
    w = torch.from_numpy(_rand(17, 27, 16, 8, scale=0.2)).bfloat16()
    got = ck.conv3d_fwd(x, w, None)
    assert got.dtype == torch.bfloat16
    ref = ck.conv3d_fwd(x.float(), w.float(), None)
    torch.testing.assert_close(got.float(), ref, rtol=8e-3, atol=8e-3)
    dw = ck.conv3d_dw(x, got)
    assert dw.dtype == torch.float32
    k = torch.from_numpy(_rand(18, 16, 27)).bfloat16()
    out = hc.head_fwd(x, k)
    torch.testing.assert_close(out.float(), hc.head_fwd(x.float(), k.float()),
                               rtol=8e-3, atol=8e-3)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 2, 2, 2, 4)
    w = torch.zeros(27, 4, 8)
    with pytest.raises(TypeError):
        ck.conv3d_fwd(x.double(), w.double(), None)
    with pytest.raises(ValueError):
        ck.conv3d_fwd(x.transpose(1, 2), w, None)
    with pytest.raises(ValueError):
        ck.conv3d_fwd(x, torch.zeros(27, 3, 8), None)
    with pytest.raises(RuntimeError):  # neither cpu nor cuda: no silent path
        ck.conv3d_fwd(x.to("meta"), w.to("meta"), None)
    with pytest.raises(RuntimeError):
        hc.head_fwd(x.to("meta"), torch.zeros(4, 27, device="meta"))


@pytest.mark.parametrize("m,rows,co", [(524288, 27, 32), (1024, 6912, 512),
                                       (98304, 1728, 64), (8, 27, 32)])
def test_dw_split_covers_every_voxel(m, rows, co):
    s, chunk = ck.dw_split(m, rows, co, sms=132)
    assert chunk % ck._DW_CHUNK == 0 and s >= 1
    assert (s - 1) * chunk < m <= s * chunk


# The model's 3³ convs with Co > 1 as (Ci, Co, level) and the two calls of a
# training step at batch 4 (as chip_smoke.py's CONVS and CALLS): the global
# views at (64, 64, 32), the 6 local views at 16³ concatenated.
MODEL_CONVS = [(1, 32, 0), (32, 64, 0), (64, 64, 1), (64, 128, 1), (128, 128, 2),
               (128, 256, 2), (256, 256, 3), (256, 512, 3), (512, 256, 2), (256, 256, 2),
               (256, 128, 1), (128, 128, 1), (128, 64, 0), (64, 64, 0)]
MODEL_CALLS = [(4, (64, 64, 32)), (24, (16, 16, 16))]


def _fwd_launches():
    """(m, Ci, Co) of every forward and dx launch of a step, then of CONV_SHAPES."""
    out = []
    for b, size in MODEL_CALLS:
        for ci, co, level in MODEL_CONVS:
            m = b * int(np.prod([s >> level for s in size]))
            out.append((m, ci, co))
            if ci > 1:  # the stem's input needs no gradient
                out.append((m, co, ci))
    out += [(b * d * h * w, ci, co) for b, d, h, w, ci, co in CONV_SHAPES]
    return out


@pytest.mark.parametrize("m,ci,co", _fwd_launches())
def test_fwd_split_covers_every_k(m, ci, co):
    """The forward's K splits tile [0, 27·Ci) once, in whole chunks, at both
    dtypes' chunk depth; a grid with two blocks per SM is left unsplit."""
    k = 27 * ci
    for bk in set(ck._BK.values()):
        s, kchunk = ck.fwd_split(m, k, co, sms=132, bk=bk)
        assert s >= 1 and (kchunk % bk == 0 or (ci, s, kchunk) == (1, 1, 27))
        covered = np.zeros(k, dtype=int)
        for z in range(s):
            covered[z * kchunk:min((z + 1) * kchunk, k)] += 1
        assert (covered == 1).all()
        tiles = -(-m // ck._BM) * -(-co // max(ck.fwd_tile(ci, co), 1))
        if tiles >= 2 * 132:
            assert s == 1


def _split_fwd_emulation(x, wmat, bias, s, kchunk):
    """The split forward in plain torch: each split's f32 partial over its
    K range k = tap·Ci + ci, the partials added in split order, then the bias."""
    ci = x.shape[-1]
    wins = torch.cat([win for _, win in ck.windows(x)], dim=1)  # (M, 27·Ci), k order
    wk = wmat.reshape(27 * ci, -1).float()
    parts = [wins[:, z * kchunk:(z + 1) * kchunk] @ wk[z * kchunk:(z + 1) * kchunk]
             for z in range(s)]
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc + bias.float()


@pytest.mark.parametrize("shape", CONV_SHAPES + [(4, 2, 2, 2, 32, 64)])
def test_split_forward_equals_plain(shape):
    b, d, h, w, ci, co = shape
    x = torch.from_numpy(_rand(19, b, d, h, w, ci))
    wmat = torch.from_numpy(_rand(20, 27, ci, co, scale=0.2))
    bias = torch.from_numpy(_rand(21, co))
    s, kchunk = ck.fwd_split(b * d * h * w, 27 * ci, co, sms=132, bk=16)
    s = max(s, 2)  # at least two splits, so the sum is exercised
    kchunk = -(-27 * ci // s)
    got = _split_fwd_emulation(x, wmat, bias, s, kchunk)
    want = ck.conv3d_fwd_plain(x, wmat, bias).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ci,co,bn", [(32, 64, 64), (64, 64, 64), (64, 128, 128),
                                      (512, 256, 128), (128, 64, 64), (64, 32, 32),
                                      (8, 24, 32), (256, 512, 128)])
def test_fwd_tile_follows_co(ci, co, bn):
    """N of the forward tile follows Co: level 0's Co = 32..64 is not padded
    to 128.  The filter grad's (channel, column) tile follows (Ci, Co)."""
    assert ck.fwd_tile(ci, co) == bn
    assert ck.dw_tile(ci, co) == ((32, 64) if ci < 64 else (64, 128 if co >= 128 else 64))


def test_stem_takes_its_own_path():
    """Ci = 1 routes to the stem kernels (no tile, no K split, 27 dw rows in
    one tile of 32 columns), and the vector checks let it through."""
    assert ck.fwd_tile(1, 32) == 0
    assert ck.fwd_split(524288, 27, 32, sms=132, bk=32) == (1, 27)
    assert ck.dw_tile(1, 32) == (1, 32)
    s, chunk = ck.dw_split(524288, 27, 32, sms=132)
    assert s > 1 and (s - 1) * chunk < 524288 <= s * chunk
    x = torch.zeros(1, 4, 4, 4, 1)
    ck.check_vectors((x, torch.zeros(27, 1, 32)), 1, 32)


def test_vector_checks_reject_what_the_copies_cannot_take():
    """16-byte copies: a misaligned pointer, a Ci or a Co that is not a
    multiple of the vector (8 bf16 or 4 f32) raise; checked on CPU tensors,
    nothing is launched."""
    w = torch.zeros(27, 8, 8)
    ck.check_vectors((torch.zeros(1, 2, 2, 2, 8), w), 8, 8)
    misaligned = torch.zeros(1 + 2 * 2 * 2 * 8)[1:].reshape(1, 2, 2, 2, 8)
    with pytest.raises(ValueError, match="aligned"):
        ck.check_vectors((misaligned, w), 8, 8)
    with pytest.raises(ValueError, match="Ci=12"):
        ck.check_vectors((torch.zeros(1, 2, 2, 2, 12).bfloat16(),
                          torch.zeros(27, 12, 8).bfloat16()), 12, 8)
    ck.check_vectors((torch.zeros(1, 2, 2, 2, 12), torch.zeros(27, 12, 8)), 12, 8)
    with pytest.raises(ValueError, match="Co=6"):
        ck.check_vectors((torch.zeros(1, 2, 2, 2, 8), torch.zeros(27, 8, 6)), 8, 6)
