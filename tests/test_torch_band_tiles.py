"""The banded Co=1 product's kernel (#9, ``co1_band``): its block walk, its
geometry and its padded route, on the CPU.

No card here: the CUDA kernel runs only on one (``chip_smoke.py`` phase 9
holds it to its plain version there).  What the CPU can hold is the
arithmetic it is built on.  ``_emulate`` walks the blocks of
``csrc/proto_co1.cu``'s ``co1_band_kernel``: row segments of ``band_tiles``,
the slab of one depth plane with a halo row above and below each segment
(zero off the volume, in the w pad and past K), the 3 th taps read at row
offsets 0, 1, 2, K chunks of ``band_stages``, the splits of
``conv3d_packed.split`` added in order.  It must equal ``band_plain`` for
any bands (the kernel computes the full product, zeros included); the
tiling must cover every output row and every K index once at the tool's
shapes.
"""

import math

import numpy as np
import pytest
import torch

from pcrlv2_tpu_torch.ops import conv3d_kernel as ck
from pcrlv2_tpu_torch.ops import conv3d_packed as cp
from pcrlv2_tpu_torch.tools import proto_co1_kernel as co


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (several share a host), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMS = 132  # the H100's SMs
DTYPES = (torch.float32, torch.bfloat16)


def _rows(geo, h, nplanes, t):
    """``band_row`` for the ``bm`` rows of block ``t`` (an int or an array
    of blocks): (slab row at th = 0 or -1, output row (b, d, h))."""
    t = np.asarray(t)[..., None]
    plane0 = np.where(geo["P"] == 1, t // geo["tpp"], t * geo["P"])
    h0 = np.where(geo["P"] == 1, (t % geo["tpp"]) * geo["L"], 0)
    r = np.arange(geo["bm"])
    s, q = r // geo["L"], r % geo["L"]
    plane, hh = plane0 + s, h0 + q
    ok = (s < geo["P"]) & (plane < nplanes) & (hh < h)
    return np.where(ok, s * (geo["L"] + 2) + q, -1), plane * h + hh


def _table(geo, h, d, nplanes, t):
    """``band_table``: per slab row, its x row (plane·H + h) or -1, and d."""
    plane0 = t // geo["tpp"] if geo["P"] == 1 else t * geo["P"]
    h0 = (t % geo["tpp"]) * geo["L"] if geo["P"] == 1 else 0
    j = np.arange(geo["rows"])
    s, hh = j // (geo["L"] + 2), h0 - 1 + j % (geo["L"] + 2)
    plane = plane0 + s
    ok = (plane < nplanes) & (hh >= 0) & (hh < h)
    return np.where(ok, plane * h + hh, -1), plane % d


def _emulate(x, bands, dtype, splits=None):
    """The kernel's output in f32 on the operands the wrapper launches it
    with (Ci and N padded as ``band_route`` says): per block, per K split,
    per stage the slab and its 3 th products; the splits' partials added in
    order.  ``dtype`` picks the stage depth (BK) and the copy width of that
    dtype's kernel; ``splits`` forces (S, per)."""
    b, d, h, w, ci = x.shape
    ci_p, n = ck.vector_channels(ci, w, dtype, stem=False)
    xk, bk = co.band_operands(x, bands, ci_p, n)
    depth, bn = co._BAND[dtype][0], co.band_width(n)
    geo = co.band_tiles(b, d, h, bn, dtype)
    walk = co.band_stages(w, ci_p, dtype)
    s, per = splits or cp.split(geo["tiles"] * math.ceil(n / bn), len(walk), SMS)
    xr = xk.reshape(b * d * h, w * ci_p).float()
    bf = torch.cat([bk.float(), torch.zeros(9, depth, n)], 1)  # zero past K
    out = torch.zeros(b * d * h, n)
    for t in range(geo["tiles"]):
        tabx, tabd = _table(geo, h, d, b * d, t)
        rows, m = _rows(geo, h, b * d, t)
        base = np.maximum(rows, 0)
        total = torch.zeros(geo["bm"], n)
        for z in range(s):
            acc = torch.zeros(geo["bm"], n)
            for td, k0 in walk[z * per:(z + 1) * per]:
                k = np.arange(k0, k0 + depth)
                kin = torch.from_numpy((k >= ci_p) & (k < (w + 1) * ci_p))
                rin = (tabx >= 0) & (tabd + td - 1 >= 0) & (tabd + td - 1 < d)
                src = np.where(rin, tabx + (td - 1) * h, 0)
                cols = np.clip(k - ci_p, 0, w * ci_p - 1)
                slab = xr[src][:, cols] * torch.from_numpy(rin)[:, None] * kin[None]
                for th in range(3):
                    acc += slab[base + th] @ bf[3 * td + th, k0:k0 + depth]
            total = total + acc
        ok = rows >= 0
        out[m[ok]] = total[torch.from_numpy(ok)]
    return out.reshape(b, d, h, n)[..., :w]


@pytest.mark.parametrize("shape,dtype,splits", [
    ((2, 3, 5, 4, 8), torch.float32, None),        # 51 planes a block, H ∤ 256
    ((1, 2, 260, 4, 4), torch.float32, (3, 1)),    # a plane of two segments, ragged
    ((2, 3, 1, 8, 8), torch.bfloat16, None),       # H = 1: 128-row blocks
    ((1, 3, 7, 7, 3), torch.float32, None),        # padded: Ci 3 → 4, N 7 → 8
    ((2, 2, 6, 20, 5), torch.bfloat16, (5, 2)),    # padded: Ci 5 → 8, N 20 → 24
    ((3, 2, 3, 8, 16), torch.bfloat16, None),      # ragged M: 18 rows of a 256-row block
])
def test_block_walk_equals_plain(shape, dtype, splits):
    """The kernel's blocked, split order on random (not banded) bands equals
    ``band_plain`` in f32: the same products summed in another order, 1e-5
    of the largest entry."""
    b, d, h, w, ci = shape
    rng = np.random.RandomState(60)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    bands = torch.from_numpy((rng.randn(9, (w + 2) * ci, w) * 0.2).astype(np.float32))
    if h == 1:  # 256 rows of one-row planes would not fit a block
        assert co.band_tiles(b, d, h, co.band_width(w), dtype)["bm"] == 128
    want = co.band_plain(x, bands)
    got = _emulate(x, bands, dtype, splits)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("batch", [2, 32])
@pytest.mark.parametrize("shape", co.SHAPES)
def test_blocks_cover_every_row_and_k_index_once(shape, batch):
    """At the tool's shapes: every output row is one row of one block; each
    th tap of a valid row reads the slab row that holds x row h + th − 1 of
    its plane (or a zero row off the plane); the K splits walk every (tap,
    column) once; the tool's shapes take the vector route and a block fits
    the card's shared memory, in both dtypes."""
    d, h, w, ci = shape
    bn = co.band_width(w)
    for dtype in DTYPES:
        geo = co.band_tiles(batch, d, h, bn, dtype)
        assert geo["bm"] == 256 and co.band_smem(geo, bn, dtype) <= cp.SMEM_LIMIT
        assert co.band_route(ci, w, dtype) == "vector"
    rows, m = _rows(geo, h, batch * d, np.arange(geo["tiles"]))
    hits = np.bincount(m[rows >= 0], minlength=batch * d * h)
    assert (hits == 1).all()
    for t in sorted({0, geo["tiles"] // 2, geo["tiles"] - 1}):
        tabx, _ = _table(geo, h, d, batch * d, t)
        ok = rows[t] >= 0
        mh = m[t][ok] % h
        for th in range(3):
            sh = mh + th - 1
            want = np.where((sh >= 0) & (sh < h), m[t][ok] + th - 1, -1)
            assert (tabx[rows[t][ok] + th] == want).all(), (t, th)
    for dtype in DTYPES:
        walk = co.band_stages(w, ci, dtype)
        s, per = cp.split(geo["tiles"] * math.ceil(w / bn), len(walk), SMS)
        assert (s - 1) * per < len(walk) <= s * per
        kdim, depth = (w + 2) * ci, co._BAND[dtype][0]
        covered = np.zeros(9 * kdim, np.int64)
        for td, k0 in walk:
            for th in range(3):
                tap = 3 * td + th
                covered[tap * kdim + k0:tap * kdim + min(k0 + depth, kdim)] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("ci,w,dtype,route", [
    (64, 32, torch.bfloat16, "vector"), (128, 16, torch.float32, "vector"),
    (3, 7, torch.float32, "padded"), (12, 8, torch.bfloat16, "padded"),
    (12, 8, torch.float32, "vector"), (8, 33, torch.bfloat16, "padded"),
])
def test_band_route_pads_to_the_copy_width(ci, w, dtype, route):
    """Ci and W that are not multiples of the 16-byte copy's width are padded
    to them: the band columns past W are zero, and the padded channels give
    ``band_plain``'s answer (zero channels add exact zeros; a wider product
    may sum in another order, so within 1e-6 of the largest entry)."""
    assert co.band_route(ci, w, dtype) == route
    ci_p, n = ck.vector_channels(ci, w, dtype, stem=False)
    rng = np.random.RandomState(61)
    x = torch.from_numpy(rng.randn(1, 2, 3, w, ci).astype(np.float32)).to(dtype)
    bands = torch.from_numpy(rng.randn(9, (w + 2) * ci, w).astype(np.float32)).to(dtype)
    xp, bp = co.band_operands(x, bands, ci_p, n)
    assert xp.shape[-1] == ci_p and bp.shape == (9, (w + 2) * ci_p, n)
    assert not bp[..., w:].any()
    got = co.band_plain(xp, bp[..., :w].contiguous()).float()
    want = co.band_plain(x, bands).float()
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), err
