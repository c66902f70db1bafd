"""The Co=1 head kernels' block walk (#3 forward, #4 fused backward) and
their padded-channel route, and the prototype tool's stencil (#8) on #3's
forward template, on the CPU.

No card here: the CUDA kernels run only on one (``chip_smoke.py`` holds them
to their plain versions there).  What the CPU can hold is the arithmetic
they are built on.  ``_emulate_fwd`` walks the blocks of
``csrc/head_conv.cu``'s forward: halo tiles of ``hc.tile``, depth chunks of
``hc.fwd_split``, per-plane tap partials summed over channel chunks of
``hc.CHUNK``, and the three rolling output accumulators.  ``_emulate_bwd``
walks the backward's: per-plane tiles, the shifted-cotangent matrix G27,
dx = G27 @ Kᵀ, the dK partial of each block of the persistent grid of
``hc.bwd_grid`` summed over its tiles in order, and the blocks' partials
added in the second launch's fixed order.  Both
must equal the plain versions at the main path's planes and channels (the
batch cut to 1; the tiling and split are the main path's own).
``_emulate_stencil`` runs #3's walk on #8's launch
(``proto_co1_kernel.stencil_geometry``): its weights w27 (27, Ci) read
through the template's strides, Ci above ``hc.MAX_CI`` in channel slices
whose partials are added in slice order; it must equal ``co1_plain``.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops import head_conv as hc
from pcrlv2_tpu_torch.tools import proto_co1_kernel as co


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (several share a host), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMS = 132  # the H100's SMs
# (batch of the main path, D, H, W, Ci): the six head forwards of a training
# step at batch 4 (globals) and 6·4 (locals); the first three also run the
# backward
FWD_SHAPES = [(4, 64, 64, 32, 64), (4, 32, 32, 16, 128), (4, 16, 16, 8, 256),
              (24, 16, 16, 16, 64), (24, 8, 8, 8, 128), (24, 4, 4, 4, 256)]
BWD_SHAPES = FWD_SHAPES[:3]
# (B, D, H, W, Ci) off the main path: W = 1, odd W, a plane of 70, D < 3
ODD_SHAPES = [(2, 3, 5, 1, 8), (1, 2, 7, 9, 4), (1, 1, 70, 1, 12), (2, 4, 3, 5, 36)]


def _inputs(shape, seed):
    b, d, h, w, ci = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, d, h, w, ci), generator=gen) * 0.5
    g = torch.randn((b, d, h, w), generator=gen) * 0.5
    k = (torch.rand((ci, 27), generator=gen) * 2 - 1) / math.sqrt(27 * ci)
    return x, g, k


def _close(got, ref, tol=1e-5):
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


def _padded_hw(h, w):
    th, tw = hc.tile(w)
    return th, tw, -(-h // th) * th, -(-w // tw) * tw


def _emulate_fwd(x, k, chunk):
    """#3's block walk, vectorized over the blocks of one depth chunk."""
    b, d, h, w, ci = x.shape
    th, tw, hn, wn = _padded_hw(h, w)
    ck = hc.CHUNK[torch.float32]
    # zero planes at z = -1 and D, zero rows and columns around and past
    # the plane: what the kernel's zero-fill copies give
    xp = F.pad(x.float(), (0, 0, 1, wn - w + 1, 1, hn - h + 1, 1, 1))
    halo = xp.unfold(2, th + 2, th).unfold(3, tw + 2, tw)  # (b, d+2, nth, ntw, ci, th+2, tw+2)
    halo = halo.permute(0, 1, 2, 3, 5, 6, 4)
    kf = F.pad(k.float(), (0, 5))  # 27 columns padded to 32
    out = torch.zeros(b, d, hn // th, wn // tw, th, tw)
    for z0 in range(0, d, chunk):
        z1 = min(d, z0 + chunk)
        o_m1 = o_0 = o_p1 = torch.zeros(b, hn // th, wn // tw, th, tw)
        for z in range(z0 - 1, z1 + 1):
            p = sum(halo[:, z + 1, ..., c0:c0 + ck] @ kf[c0:c0 + ck] for c0 in range(0, ci, ck))
            for i in range(3):
                for j in range(3):
                    win = p[..., i:i + th, j:j + tw, :]
                    o_p1 = o_p1 + win[..., i * 3 + j]
                    o_0 = o_0 + win[..., 9 + i * 3 + j]
                    o_m1 = o_m1 + win[..., 18 + i * 3 + j]
            if z - 1 >= z0:
                out[:, z - 1] = o_m1
            o_m1, o_0, o_p1 = o_0, o_p1, torch.zeros_like(o_p1)
    return out.permute(0, 1, 2, 4, 3, 5).reshape(b, d, hn, wn)[:, :, :h, :w]


def _emulate_bwd(x, g, k, grid):
    """#4's block walk: tiles in the persistent grid's order, per-block dK
    partials over channel chunks, the partials added in 8 row groups."""
    b, d, h, w, ci = x.shape
    th, tw, hn, wn = _padded_hw(h, w)
    ck = hc.CHUNK[torch.float32]
    gp = F.pad(g.float(), (1, wn - w + 1, 1, hn - h + 1, 1, 1))
    inside = F.pad(torch.ones(b, d, h, w), (0, wn - w, 0, hn - h))
    g27 = torch.zeros(b, d, hn, wn, 32)
    for t, (td, th_, tw_) in enumerate(hc.OFFSETS):
        g27[..., t] = gp[:, 2 - td:2 - td + d, 2 - th_:2 - th_ + hn,
                         2 - tw_:2 - tw_ + wn] * inside

    def tiles(v):  # (b, d, hn, wn, c) → (tiles, 128, c) in the kernel's tile order
        c = v.shape[-1]
        v = v.reshape(b, d, hn // th, th, wn // tw, tw, c).permute(0, 1, 2, 4, 3, 5, 6)
        return v.reshape(-1, th * tw, c)

    xt = tiles(F.pad(x.float(), (0, 0, 0, wn - w, 0, hn - h)))
    gt = tiles(g27)
    kt = F.pad(k.float(), (0, 5)).T  # (32, ci)
    dx = torch.cat([gt @ kt[:, c0:c0 + ck] for c0 in range(0, ci, ck)], -1)
    per_tile = torch.cat([xt[..., c0:c0 + ck].transpose(1, 2) @ gt
                          for c0 in range(0, ci, ck)], 1)  # (tiles, ci, 32)
    n = per_tile.shape[0]
    per_tile = F.pad(per_tile, (0, 0, 0, 0, 0, -n % grid)).reshape(-1, grid, ci, 32)
    partial = torch.zeros(grid, ci, 32)
    for step in per_tile:  # block i adds tiles i, i + grid, ... in order
        partial = partial + step
    rows = []
    for r in range(8):  # the second launch: row group r sums s = r, r + 8, ...
        acc = torch.zeros(ci, 32)
        for blk in partial[r::8]:
            acc = acc + blk
        rows.append(acc)
    dk = rows[0]
    for acc in rows[1:]:
        dk = dk + acc
    dx = dx.reshape(b, d, hn // th, wn // tw, th, tw, ci).permute(0, 1, 2, 4, 3, 5, 6)
    return dx.reshape(b, d, hn, wn, ci)[:, :, :h, :w], dk[:, :27]


@pytest.mark.parametrize("shape", FWD_SHAPES + ODD_SHAPES, ids=str)
def test_forward_block_walk_matches_plain(shape):
    """#3 at the main path's planes and Ci (batch 1, the main path's depth
    split) and off it, in f32 at 1e-5 of the largest output."""
    batch = shape[0] if shape in ODD_SHAPES else 1
    chunk = hc.fwd_split(*shape[:4], SMS, torch.float32)
    x, _, k = _inputs((batch,) + shape[1:], seed=1)
    _close(_emulate_fwd(x, k, chunk), hc.head_fwd_plain(x, k))


@pytest.mark.parametrize("shape", BWD_SHAPES + ODD_SHAPES, ids=str)
def test_backward_block_walk_matches_plain(shape):
    """#4 at the main path's planes and Ci (batch 1, the main path's grid)
    and off it: dx and dK in f32 at 1e-5 of their largest entries."""
    batch = shape[0] if shape in ODD_SHAPES else 1
    grid = hc.bwd_grid(*shape[:4], SMS, torch.float32)
    x, g, k = _inputs((batch,) + shape[1:], seed=2)
    dx, dk = _emulate_bwd(x, g, k, min(grid, batch * shape[1] * hc.n_tiles(1, *shape[2:4])))
    ref_dx, ref_dk = hc.head_bwd_plain(x, g, k)
    _close(dx, ref_dx)
    _close(dk, ref_dk)


# (output planes per block, blocks) of the forward at the six main-path
# shapes, per dtype
SPLITS = {torch.float32: [(16, 256), (2, 256), (1, 64), (4, 192), (1, 192), (1, 96)],
          torch.bfloat16: [(16, 256), (2, 256), (2, 32), (4, 192), (2, 96), (2, 48)]}


@pytest.mark.parametrize("dtype", sorted(SPLITS, key=str), ids=str)
def test_main_path_tiling_and_splits(dtype):
    """The forward's tiles and depth chunks at the six main-path shapes
    cover every output plane once and fill at most one wave of two blocks an
    SM; the backward's grid is fixed by the shape."""
    blocks = []
    for b, d, h, w, _ in FWD_SHAPES:
        th, tw = hc.tile(w)
        assert th * tw == hc.TILE and (tw <= w or tw == 4)
        chunk = hc.fwd_split(b, d, h, w, SMS, dtype)
        parts = -(-d // chunk)
        assert (parts - 1) * chunk < d <= parts * chunk
        assert chunk >= min(d, hc.MIN_PLANES[dtype])
        blocks.append((chunk, hc.n_tiles(b, h, w) * parts))
    assert blocks == SPLITS[dtype]
    assert all(n <= 2 * SMS for _, n in blocks)
    grids = {torch.float32: [264, 264, 64], torch.bfloat16: [396, 396, 64]}
    assert [hc.bwd_grid(*s[:4], SMS, dtype) for s in BWD_SHAPES] == grids[dtype]


@pytest.mark.parametrize("ci", [1, 3, 17])
def test_padded_route_matches_plain(ci):
    """Ci that the 16-byte copies cannot take: x and K zero-padded to the
    vector width (what the wrappers do on the card), the block walks on the
    padded operands, the results sliced back, against the plain versions."""
    x, g, k = _inputs((2, 3, 5, 6, ci), seed=3)
    for dtype in (torch.float32, torch.bfloat16):
        assert hc.route(ci, dtype) == "padded"
        assert hc.vector_channels(ci, dtype) % (8 if dtype == torch.bfloat16 else 4) == 0
    civ = hc.vector_channels(ci, torch.float32)
    xp, kp = hc.padded_operands(x, k, civ)
    assert xp.shape[-1] == kp.shape[0] == civ and torch.equal(xp[..., :ci], x)
    _close(_emulate_fwd(xp, kp, hc.fwd_split(2, 3, 5, 6, SMS, torch.float32)),
           hc.head_fwd_plain(x, k))
    dx, dk = _emulate_bwd(xp, g, kp, 7)
    ref_dx, ref_dk = hc.head_bwd_plain(x, g, k)
    _close(dx[..., :ci], ref_dx)
    assert torch.equal(dx[..., ci:], torch.zeros_like(dx[..., ci:]))
    _close(dk[:ci], ref_dk)


def _emulate_stencil(x, w27, batch):
    """#8's launch at ``batch`` samples, walked on x: #3's block walk on each
    channel slice, k[c, t] = w27[t, c0 + c] (the strides kc = 1, kt = Ci),
    the slices' f32 partials added in slice order."""
    b, d, h, w, ci = x.shape
    geo = co.stencil_geometry(batch, d, h, w, ci, SMS, torch.float32)
    total = None
    for c0 in range(0, ci, geo["cs"]):
        part = _emulate_fwd(x[..., c0:c0 + geo["cs"]], w27[:, c0:c0 + geo["cs"]].T, geo["chunk"])
        total = part if total is None else total + part
    return total


def _w27(ci, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((27, ci), generator=gen) * 2 - 1) / math.sqrt(27 * ci)


@pytest.mark.parametrize("shape", [(co.BATCH,) + s for s in co.SHAPES], ids=str)
def test_stencil_block_walk_matches_co1_plain(shape):
    """#8 at the tool's two shapes (batch cut to 1; the depth chunks those of
    B = 32) on w27 (27, Ci) weights: equal to ``co1_plain`` in f32 at 1e-5
    of the largest output."""
    x, _, _ = _inputs((1,) + shape[1:], seed=4)
    w27 = _w27(shape[4], seed=5)
    _close(_emulate_stencil(x, w27, shape[0]), co.co1_plain(x, w27))


def test_stencil_channel_slices_match_co1_plain():
    """Ci = 1100 > ``hc.MAX_CI``: slices of at most ``MAX_CI`` channels, each
    a multiple of the ring's chunk, in both dtypes (bf16 on 1104 padded
    channels); the f32 walk over them, partials added in order, equals
    ``co1_plain``."""
    for dtype in (torch.float32, torch.bfloat16):
        ci = hc.vector_channels(1100, dtype)
        geo = co.stencil_geometry(1, 3, 5, 7, ci, SMS, dtype)
        assert geo["n_ci"] == 3 and geo["cs"] <= hc.MAX_CI
        assert geo["cs"] % hc.CHUNK[dtype] == 0
        assert (geo["n_ci"] - 1) * geo["cs"] < ci <= geo["n_ci"] * geo["cs"]
    x, _, _ = _inputs((1, 3, 5, 7, 1100), seed=6)
    w27 = _w27(1100, seed=7)
    _close(_emulate_stencil(x, w27, 1), co.co1_plain(x, w27))


@pytest.mark.parametrize("shape", [(1, 2, 3, 300, 8), (2, 5, 70, 257, 1104)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_stencil_geometry_covers_each_voxel_once(shape, dtype):
    """W > 256 (the old stencil's limit): the blocks of #8's grid, decoded as
    the template decodes blockIdx (depth chunk, tile column, tile row,
    sample; the channel slice on y), write every output voxel exactly once
    per slice, and no tile's halo rows exceed the template's RMAX = 208."""
    b, d, h, w, ci = shape
    geo = co.stencil_geometry(b, d, h, w, ci, SMS, dtype)
    th, tw = hc.tile(w)
    tiles_w, tiles_h = -(-w // tw), -(-h // th)
    nsplit = -(-d // geo["chunk"])
    writes = torch.zeros((b, d, h, w), dtype=torch.int32)
    for blk in range(b * tiles_h * tiles_w * nsplit):
        sp, idx = blk % nsplit, blk // nsplit
        w0, idx = idx % tiles_w * tw, idx // tiles_w
        h0, bb = idx % tiles_h * th, idx // tiles_h
        z0 = sp * geo["chunk"]
        writes[bb, z0:min(d, z0 + geo["chunk"]), h0:h0 + th, w0:w0 + tw] += 1
        assert (min(th, h - h0) + 2) * (tw + 2) <= 208
    assert torch.equal(writes, torch.ones_like(writes))
