"""Kernel #7: the im2col conv prototype, CONCAT27 and CONCAT9, on the GPU.

    python -m pcrlv2_tpu_torch.tools.proto_conv

Port of ``tools/proto_conv.py``: a SAME 3³ conv with bias, x (B, D, H, W, Ci)
NDHWC, w (3, 3, 3, Ci, Co) DHWIO, bias (Co,), accumulated in f32 from the
bias and cast to x's dtype, in two formulations of the TPU kernel
(``_make_kernel``): ``mode="27"``, one contraction of K = 27·Ci over the 27
tap windows side by side, and ``mode="9"``, three contractions of K = 9·Ci,
one per depth tap.  CONCAT27 is the im2col kernel's body (#5), so both modes
run on #5's slab template (``csrc/slab_conv.cuh``; the kernels and entries
are in ``csrc/proto_conv.cu``, whose header says what bounds them): 128-voxel
tiles, K in stages of one depth tap and one channel chunk fed by a
``cp.async`` ring, bf16 on tensor cores and f32 on an FMA micro-tile.  The
two modes differ only in the order of the stages: CONCAT27 walks the channel
chunks outer and the depth taps inner (#5's order), CONCAT9 the depth taps
outer (the TPU kernel's three dots).  They launch through
``ops/conv3d_packed.py::launch``, #5's host logic (tiles, K split, the
zero-padded route for Ci or Co the 16-byte copies cannot take, such as the
sweep's Co = 1), and count under ``proto_conv27`` / ``proto_conv9``.

``main()`` sweeps the JAX tool's shapes at B = 32 in bf16 and prints, per
shape, the cuDNN conv's time (a yardstick only, where the JAX tool prints
XLA's), each variant's time and TFLOP/s, and its error against the plain
version.  It needs a GPU unless ``device="cpu"`` is passed (then it runs the
plain versions and times nothing).  ``chip_smoke.py`` phase 9 drives it.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pcrlv2_tpu_torch.ops import conv3d_packed as cp
from pcrlv2_tpu_torch.ops.conv3d_kernel import OFFSETS
from pcrlv2_tpu_torch.tools._common import Case, fmt_ms, rel_err, setup, tflops, time_ms

#: (D, H, W, Ci, Co) of the JAX tool's sweep (``tools/proto_conv.py:115-120``)
SHAPES = [(64, 64, 32, 32, 64), (32, 32, 16, 64, 64), (32, 32, 16, 64, 128),
          (64, 64, 32, 64, 64), (64, 64, 32, 128, 64), (64, 64, 32, 64, 1)]
BATCH = 32
MODES = ("27", "9")


def taps_per_pass(mode: str) -> int:
    return 27 if mode == "27" else 9


# ---------------------------------------------------------------------------
# plain version (CPU path and the card-side reference)
# ---------------------------------------------------------------------------


def conv_plain(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor, mode: str,
               chunk: int | None = 1) -> torch.Tensor:
    """``bias + Σ_pass cols_pass @ wmat[rows of the pass]`` in f32, the
    pass's tap windows side by side (27 taps in one pass, or 9 per depth
    tap), cast to ``x.dtype``.  ``chunk`` samples at a time (``None``: the
    whole batch at once): at (64, 64, 32) Ci = 128 one sample's 27 windows
    are 1.8 GB of f32."""
    b, d, h, w, ci = x.shape
    co = wmat.shape[-1]
    taps = taps_per_pass(mode)
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    step = b if chunk is None else chunk
    for b0 in range(0, b, step):
        xp = F.pad(x[b0:b0 + step], (0, 0, 1, 1, 1, 1, 1, 1)).float()
        n = xp.shape[0] * d * h * w
        acc = bias.float().expand(n, co)
        for t0 in range(0, 27, taps):
            cols = torch.cat([xp[:, td:td + d, th:th + h, tw:tw + w].reshape(n, ci)
                              for td, th, tw in OFFSETS[t0:t0 + taps]], -1)
            acc = acc + cols @ wmat[t0 * ci:(t0 + taps) * ci].float()
        out[b0:b0 + step] = acc.reshape(-1, d, h, w, co).to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# kernel wrapper and the tool's function
# ---------------------------------------------------------------------------


def proto_conv(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
               mode: str) -> torch.Tensor:
    """Kernel #7: x (B, D, H, W, Ci), wmat (27·Ci, Co), bias (Co,), all of
    one dtype → (B, D, H, W, Co) in that dtype; ``mode`` "27" or "9"."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    ci = x.shape[-1]
    if wmat.dim() != 2 or wmat.shape[0] != 27 * ci or bias.shape != wmat.shape[1:]:
        raise ValueError(f"weights {tuple(wmat.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit Ci={ci}")
    co = wmat.shape[1]

    def plain(x, wm, bias):
        return conv_plain(x, wm.reshape(27 * ci, co), bias, mode)

    return cp.launch(f"proto_conv{mode}", plain, x, wmat.view(27, ci, co), bias,
                     lib="proto_conv")


def conv3d_im2col(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  mode: str = "27") -> torch.Tensor:
    """SAME 3³ conv, x (B, D, H, W, Ci), w (3, 3, 3, Ci, Co), bias (Co,), as
    the JAX tool's ``conv3d_im2col``: weights and bias cast to x's dtype."""
    ci, co = w.shape[3:]
    return proto_conv(x, w.to(x.dtype).reshape(27 * ci, co).contiguous(),
                      bias.to(x.dtype).contiguous(), mode)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def shape_cases(shape, batch: int, dtype: torch.dtype, device, seed: int = 0):
    """Inputs from ``seed`` at one sweep shape (x normal, w 0.1·normal, bias
    normal, as the JAX tool draws them) and its two cases, one per mode."""
    d, h, w, ci, co = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, d, h, w, ci), generator=gen, device=device).to(dtype)
    wt = (torch.randn((3, 3, 3, ci, co), generator=gen, device=device) * 0.1).to(dtype)
    bias = torch.randn((co,), generator=gen, device=device).to(dtype)
    wmat = wt.reshape(27 * ci, co).contiguous()
    x_nc, w_nc = x.permute(0, 4, 1, 2, 3), wt.permute(4, 3, 0, 1, 2)
    m = batch * d * h * w
    es = x.element_size()
    label = f"({d},{h},{w}) {ci:3d}->{co:3d}"
    return [Case(f"proto_conv{mode}", label,
                 lambda mode=mode: conv3d_im2col(x, wt, bias, mode),
                 lambda mode=mode: conv_plain(x, wmat, bias, mode),
                 lambda: F.conv3d(x_nc, w_nc, bias, padding=1),
                 2.0 * m * 27 * ci * co, es * (m * (ci + co) + 27 * ci * co + co))
            for mode in MODES]


def cases(device, batch: int = BATCH, dtype: torch.dtype = torch.bfloat16, shapes=SHAPES):
    for shape in shapes:
        yield from shape_cases(shape, batch, dtype, device)


def main(device=None, batch: int = BATCH, dtype: torch.dtype = torch.bfloat16,
         shapes=SHAPES) -> list:
    """Run the sweep; returns one dict per (shape, mode) with the error
    against the plain version and the times (None on the CPU)."""
    dev = setup(device)
    rows = []
    for shape in shapes:
        pair = shape_cases(shape, batch, dtype, dev)
        t_lib = time_ms(pair[0].library, dev)
        line = f"{pair[0].label}: cudnn {fmt_ms(t_lib)}{tflops(pair[0].flops, t_lib)}"
        for case in pair:
            err = rel_err(case.run(), case.plain())
            t = time_ms(case.run, dev)
            speed = "" if t is None else f" ({t_lib / t:4.2f}x cudnn)"
            line += (f" | {case.kernel} {fmt_ms(t)}{tflops(case.flops, t)}{speed}, "
                     f"err {err:.1e}")
            rows.append({"kernel": case.kernel, "case": case.label, "rel_err": err,
                         "ms": t, "library_ms": t_lib})
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
