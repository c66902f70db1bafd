#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pcrlv2_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero without the final line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``pcrlv2_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time and ``ptxas`` report;
3. hold every kernel against its plain PyTorch version at every shape the
   3D pretraining path gives it, in f32 (TF32 off) and bf16: the conv
   forward/dx (#1), filter gradient (#2), heads (#3, #4), and the packed
   (#6, forward and dx) and im2col (#5, forward) convs;
4. time each kernel and, as a yardstick only, the one PyTorch call that
   computes the same function (cuDNN), in f32 and bf16, and the plain
   version in f32; per kernel, the sums over its shapes in each dtype;
5. check a small forward of the model on the card against the same weights
   on the CPU, in f32 and under the bf16 policy of ``--amp``; then shapes
   off the main path (``ODD_SHAPES``: Ci of 1, 2, 3 and 17, Co of 5 and 70,
   W = 1, odd W, planes of under 64 voxels), where #5, #6 and the padded
   routes of #1 and #2 are held against their plain versions in f32 and
   bf16, and the head kernels (#3 forward, #4 backward) at
   ``HEAD_ODD_SHAPES`` (Ci of 1, 3, 17 and 70, W = 1, odd W, a plane of 70,
   D < 3), through the padded route where it applies; then
   ``PCRLv23d(in_channels=2)``: its f32 forward on the card against the CPU
   and one train step on the card under each ``PCRL_CONV3D`` value;
6. run the port's CLI at full width (``--synthetic --d 3 --b 4 --epochs 0
   --steps_per_epoch 10``) under ``PCRL_CONV3D=pallas`` (the default) in
   f32 and with ``--amp``, and under ``packed`` and ``im2col`` likewise, with
   every launch counter set to 0 just before each run and read just after:
   the launches must be those of the selector (``expected_launches``; a
   graph replay adds the counts its capture made), every loss finite, and
   the ``.pt`` must load strictly.  The CLI runs each step after the first
   as a CUDA graph replay; ``pallas`` f32 and ``--amp``, ``packed --amp`` and
   ``im2col --amp`` (``EAGER_RUNS``) run again on the eager loop
   (``cli.main.prepare`` → ``run_training(cuda_graph=False)``).  The step
   time is the median over the steps after the first ``WARMUP`` of each
   step's own time, recovered from the running average ``BT`` that the CLI
   logs after every step.  Then the ``EAGER_RUNS`` for ``LONG_STEPS`` steps
   at the CLI's default ``--log_every 10``, where the host reads the
   metrics only at the log, on the graphs and eagerly: step time = the mean
   of the windows 2-3.  Last, one ``train_step`` on device-resident views,
   after a warm-up step, under ``torch.cuda.set_sync_debug_mode("error")``:
   it must not synchronise with the device (the loss guard runs on the
   device);
7. run the same CLI training path (``cli.main.prepare`` → ``Trainer`` behind
   ``device_prefetch``) again under ``torch.profiler`` for each of those
   runs, on the graphs and (``EAGER_RUNS``) eagerly: device time per step
   by kernel group over ``PROFILED`` steps after the first ``WARMUP``, the
   device's busy share (that time over the unprofiled step time), device
   kernels a step and the host's CUDA API calls a step (kernel launches
   against graph launches); under ``--amp`` the #5/#6 kernels it records
   must all be their tensor-core (``_mma``) ones;
8. the disk path under ``PCRL_CONV3D=packed``, on the graphs: write a
   processed-LUNA tree (``write_synthetic_luna_tree``, 10 subsets × 2 UIDs
   × 3 pairs, so one epoch of folds 0-6 is 10 steps at b=4); the CLI's
   train loader (``cli.main.prepare``) must read through the native batch
   reader (``LunaBatchReader``; the NumPy reader fails the phase, with the
   library's build error), and one epoch of its batches must equal the
   NumPy reader's (``load_luna_sample``) bit for bit; then the CLI's path
   (``prepare`` → ``run_training``) with ``--data --epochs 1 --eval_every 1
   --eval_batches 2 --save_every 1``, then again with ``--resume
   <output>/train_state --epochs 2``: the native reader must serve every
   train batch of both runs, the run resume at epoch 2, every eval loss be
   finite, the launch counts be those of the steps and eval batches run,
   and the ``.pt`` load strictly; step time (median of steps 4-10 of epoch
   0), ``DT``, and the busy share of the same path under the profiler;
9. the kernel prototype tools (``pcrlv2_tpu_torch.tools``): each tool's
   ``main()`` (``proto_conv``, ``proto_co1_kernel`` ``main`` and ``main2``,
   ``probe_mosaic``) at the JAX tools' shapes (B = 32, bf16) with every
   launch counter set to 0 just before and read just after; then #7 (both
   modes), #8 and #9 held against their plain versions at every tool shape
   at B = 32 in bf16 and at B = 2 in f32 (TF32 off), the 14 probes of #10
   with tolerance 0, and each kernel, its plain version and the PyTorch call
   for the same function timed at B = 32 in bf16 and at B = 2 in f32; then
   #7 (both modes), #8 and #9 at ``TOOL_ODD_CONV`` / ``TOOL_ODD_STENCIL`` /
   ``TOOL_ODD_BAND`` (B of 1-3, Ci of 1, 3, 17 and 1100, Co of 1, 5 and 70,
   W of 1, 7, 33 and 300, H = 1, D < 3, planes smaller than a tile, H not
   dividing it; #9 on random, not banded, bands) in f32 and bf16; then
   #10's launch path (``probe_times``): per probe, the host-inclusive time
   per call and the device time of ``run``, of the probe's PyTorch
   expression and of ``probe_mosaic.floor`` (the same path to an empty
   kernel).  No training step launches these kernels, so their
   ``launches`` in the kernels line are the counts of the tool runs;
10. the pipelined step as CUDA graphs (``train/trainer.py::CapturedStep``)
   against the eager loop, in f32 and with ``--amp`` under ``pallas``: from
   one initial state and seed, two epochs of ``GRAPH_EPOCHS`` batches (a new
   learning rate in the second, each ending in the step-only graph) on each;
   every parameter, BN statistic, momentum buffer, the step counter, both
   generators' states and every step's metrics must be bit-identical, and
   the launch counts those of the steps (``expected_launches``, under
   replay); then ``SYNC_STEPS`` more steps of each under
   ``torch.cuda.set_sync_debug_mode("error")``, timing the host per step;
   then a graph run (``--amp``) stopped after epoch 0 and resumed from its
   saved state must equal the unbroken run;
11. the rest of the 3D pretask surface: phase 10's graph identity under
   ``--amp`` with ``--use_painting --paint_rate 1.0 --use_pixel_shuffle
   --mixup 0.2`` (``FLAGS_IDENTITY``), bit for bit, launch counts exact;
   the CLI (synthetic, ``--amp``, ``STEPS`` steps) with ``--use_painting
   --use_pixel_shuffle --mixup 0.2`` and, apart, under ``PCRL_AFFINE=exact``
   (``FLAG_RUNS``): launches exact, losses finite, step time and, under
   the profiler, device time and device kernels a step beside phase 6-7's
   ``amp`` run; the CLI on a structured phantom tree
   (``write_structured_luna_tree``) with ``--data --b 4 --use_painting
   --use_pixel_shuffle --mixup 0.2`` through the native reader; then the
   bench (``pcrlv2_tpu_torch.tools.bench``): ``main()`` at b = 32 under
   ``DEFAULT_POLICY`` (it takes the GPU lock, which every trainer before
   it must have released; the script points ``PCRL_CHIP_LOCK`` at a file
   in a temporary directory of its own for the whole run), and its timed loop (``bench.run``) at b = 32 in
   f32 and at b = 4 in both policies, ``BENCH_RUNS`` steps and trials
   reduced: volumes/s, the trials' spread and peak memory;
12. the 2D chest path (``--d 2 --n chest``), which runs none of kernels
   #1-#10 (the JAX package's 2D convs are XLA's, so the port's are cuDNN's):
   ``PCRLv2``'s forward on the card against the same weights on the CPU,
   in f32 (TF32 off) and under ``--amp``'s bf16 policy; the CLI
   (``--synthetic --d 2 --n chest --b 16``, ``run2d.sh``'s b = 64 over its
   4 GPUs, 224² global and 96² local views from a 1024² canvas) for
   ``STEPS`` steps in f32 and with ``--amp`` on the graphs: losses finite,
   the encoder ``.pt`` loading strictly into ``ResNet18Encoder``, every
   launch counter of #1-#10 at 0, step time, peak memory and, under the
   profiler, device time a step by kernel group (``GROUPS2D``), busy share
   and device kernels a step; the graph replays against the eager loop,
   two epochs from one state and seed, bit for bit, in f32 and ``--amp``,
   then ``SYNC_STEPS`` replays under the sync-debug mode; one ``train_step``
   under ``torch.cuda.set_sync_debug_mode("error")``; the disk path: a
   ``chest_train.txt`` and ``CHEST_IMAGES`` 1024² grey PNGs, ``--data ...
   --epochs 1 --eval_every 1 --save_every 1`` through ``--chest_cache auto``
   (each image decoded once), then ``--resume <output>/train_state --epochs
   2``, which must read every image from the cache and decode none (where
   Pillow is not installed, the phase says so, writes the cache entries in
   ``CachedChestReader``'s layout itself, passes ``--chest_canvas 1024`` and
   runs the same two runs); then the bench at ``BENCH_DIM=2``
   (``BENCH2D_RUNS``: 64 and 32 images under ``--amp``'s policy, 32 in f32,
   trials reduced as phase 11's): images/s, the trials' spread and peak
   memory;
13. finetuning (``--phase finetune``, ``train/finetune.py``) under
   ``pallas``: first #1 (forward and dx), #2 and #3 at the 3D finetune
   path's own launch shapes (``FT_CALLS``: b = 8 at every level), f32 and
   bf16, against their plain versions at ``TOL`` (not timed); the CLI (``--synthetic --b 8 --epochs 0 --steps_per_epoch
   10 --eval_every 1 --eval_batches 2``) at ``--d 3`` (``PCRLv23d`` at
   ``local=True`` on pseudo-masks; the README's recipe finetunes at b = 8)
   and at ``--d 2`` (``ChestClassifier``, 16 images of 224²), each in f32
   and with ``--amp``, on the graphs: launches exact (``expected_launches``'
   finetune form: #1 14 forwards + 13 dx, #2 14, #3 3 a step, #4 none; 2D
   none of #1-#10), every loss and metric finite (2D: ``eval_auc``), the
   3D ``.pt`` loading strictly into ``PCRLv23d``, the 2D one torchvision's
   ResNet-18 schema with ``fc`` 14 × 512 moved by training; each
   iteration's time over the same path, peak memory (the CLI run's trainer
   freed first) and, under the
   profiler, device time a step by kernel group, busy share and device
   kernels a step; then 3D finetuning from a pretask ``.pt`` written here
   (``--weight``) on a structured phantom tree with its masks
   (``--mask_dir``, ``--ratio 0.5``, ``--epochs 1 --eval_every 1
   --eval_batches 2 --save_every 1``): masks read from the tree, launches
   exact, eval dice finite, every ``.pt`` strict; the finetune step's
   graph replays against the eager loop, two epochs from one state and
   seed, bit for bit, in 3D and 2D (the dropout masks and generator state
   among the leaves), in f32 and ``--amp``; one 3D and one 2D finetune step
   under ``torch.cuda.set_sync_debug_mode("error")``.

Prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.  Per-shape results (errors, times,
bounds), the CLI runs and the profiles go to
``chiprun_out/chip_smoke_kernels.json``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import re
import statistics
import shutil
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FMA (no tensor
# cores) and bf16 tensor-core FLOP/s.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# |kernel − plain| / max|plain| allowed.  f32: both accumulate in f32 in
# different orders.  bf16 outputs: one bf16 rounding (2^-8) of each.  The
# filter gradients are f32 sums over up to 5·10^5 voxels in two orders.
TOL = {("float32", "out"): 2e-4, ("bfloat16", "out"): 1.6e-2,
       ("float32", "dw"): 1e-3, ("bfloat16", "dw"): 1e-3}

# (name, Ci, Co, level) of the 14 3³ convs with Co > 1, encoder then decoder,
# and the three Co=1 mask heads (unet3d.py); level 0 is the input size.
CONVS = [("down_tr64.ops.0", 1, 32, 0), ("down_tr64.ops.1", 32, 64, 0),
         ("down_tr128.ops.0", 64, 64, 1), ("down_tr128.ops.1", 64, 128, 1),
         ("down_tr256.ops.0", 128, 128, 2), ("down_tr256.ops.1", 128, 256, 2),
         ("down_tr512.ops.0", 256, 256, 3), ("down_tr512.ops.1", 256, 512, 3),
         ("up_tr256.ops.0", 512, 256, 2), ("up_tr256.ops.1", 256, 256, 2),
         ("up_tr128.ops.0", 256, 128, 1), ("up_tr128.ops.1", 128, 128, 1),
         ("up_tr64.ops.0", 128, 64, 0), ("up_tr64.ops.1", 64, 64, 0)]
HEADS = [("up_tr256.head", 256, 2), ("up_tr128.head", 128, 1), ("up_tr64.head", 64, 0)]
BATCH = 4
STEPS = 10     # CLI steps per run (phase 6)
LONG_STEPS = 30  # CLI steps of the --log_every 10 runs (phase 6)
LOG_EVERY = 10   # the CLI's default --log_every
WARMUP = 3     # first CLI steps left out of the step time and the profile
PROFILED = 4   # steps under the profiler (phase 7)
PROFILE_STEPS = WARMUP + PROFILED + 2  # batches of a profiled run (phase 7)
# (batch, input size): the two global views run at B each, the 6 local
# views concatenated at 6·B
CALLS = {"global": (BATCH, (64, 64, 32)), "local": (6 * BATCH, (16, 16, 16))}

#: device-kernel name fragment → group reported by phase 7
GROUPS = [("splitsum", "K-split sums (#1, #5, #6)"),
          ("conv3d_fwd_kernel", "conv3d_fwd (#1, fwd and dx)"),
          ("conv3d_packed_kernel", "conv3d_packed (#6, fwd and dx)"),
          ("conv3d_im2col_kernel", "conv3d_im2col (#5, fwd)"),
          ("conv3d_dw_partial", "conv3d_dw (#2) partials"),
          ("head_fwd_kernel", "head_fwd (#3)"),
          ("head_bwd_kernel", "head_bwd (#4)"),
          ("sum_partials", "dw/dK fixed-order sums"),
          ("gemm", "cuBLAS GEMM (1³ conv, k2s2 transpose conv, MLP, aug)"),
          ("elementwise", "elementwise"),
          ("reduce", "reductions (BN, GAP, losses)")]

KERNELS = {
    "conv3d_fwd": ("pcrlv2_tpu_torch/csrc/conv3d.cu", "pcrlv2_tpu/ops/pallas_conv.py:75"),
    "conv3d_dw": ("pcrlv2_tpu_torch/csrc/conv3d.cu", "pcrlv2_tpu/ops/pallas_conv.py:154"),
    "head_fwd": ("pcrlv2_tpu_torch/csrc/head_conv.cu", "pcrlv2_tpu/ops/head_conv.py:140"),
    "head_bwd": ("pcrlv2_tpu_torch/csrc/head_conv.cu", "pcrlv2_tpu/ops/head_conv.py:225"),
    "conv3d_im2col": ("pcrlv2_tpu_torch/csrc/conv3d_packed.cu",
                      "pcrlv2_tpu/ops/pallas_conv.py:307"),
    "conv3d_packed": ("pcrlv2_tpu_torch/csrc/conv3d_packed.cu",
                      "pcrlv2_tpu/ops/pallas_conv.py:380"),
}

# the kernel prototype tools' kernels (phase 9): (source, TPU kernel)
TOOL_KERNELS = {
    "proto_conv27": ("pcrlv2_tpu_torch/csrc/proto_conv.cu", "tools/proto_conv.py:25"),
    "proto_conv9": ("pcrlv2_tpu_torch/csrc/proto_conv.cu", "tools/proto_conv.py:25"),
    "proto_co1": ("pcrlv2_tpu_torch/csrc/proto_co1.cu", "tools/proto_co1_kernel.py:55"),
    "proto_co1_band": ("pcrlv2_tpu_torch/csrc/proto_co1.cu",
                       "tools/proto_co1_kernel.py:149"),
    "probe_mosaic": ("pcrlv2_tpu_torch/csrc/probe_mosaic.cu", "tools/probe_mosaic.py:28"),
}
TOOL_F32_BATCH = 2  # the f32 pass of phase 9 (the tools' own runs are bf16 at B = 32)
# (B, D, H, W, Ci, Co) of phase 9's #7 shapes off the sweep and (B, D, H, W,
# Ci) of its #9 shapes: B = 1, Ci of 1, 3 and 17, Co of 1, 5 and 70, W of 7
# and 33, planes smaller than a 128-voxel (#7) or 256-row (#9) tile, H not
# dividing it (H = 300: a plane of two segments, the second ragged; H = 1:
# #9's 128-row blocks)
TOOL_ODD_CONV = [(1, 3, 5, 7, 1, 5), (2, 3, 6, 33, 3, 70), (1, 4, 70, 7, 17, 1),
                 (3, 2, 3, 7, 17, 5), (1, 2, 9, 33, 64, 1)]
TOOL_ODD_BAND = [(1, 3, 5, 7, 1), (2, 3, 6, 33, 3), (1, 4, 70, 7, 17),
                 (3, 2, 3, 33, 16), (1, 2, 300, 8, 8), (1, 5, 9, 16, 64), (2, 3, 1, 8, 5)]
# (B, D, H, W, Ci) of phase 9's #8 shapes: W > 256 (W = 300: ten tiles a
# row), Ci of 1, 3 and 17 (the padded route), Ci = 1100 > MAX_CI (three
# channel slices), D < 3 with H = W = 1, planes smaller than a 128-voxel tile
TOOL_ODD_STENCIL = [(1, 2, 3, 300, 8), (2, 3, 5, 6, 1), (1, 2, 7, 9, 3), (2, 4, 6, 5, 17),
                    (1, 3, 5, 7, 1100), (2, 2, 1, 1, 16), (3, 4, 3, 9, 64)]
PROBE_REPS = 20  # calls a probe's device time is averaged over (phase 9)

# Launches per training step: the 14 3³ convs with Co > 1 run forward 3
# times (x1, x2, locals) = 42, their filter gradients 42 and their dx 39
# (the stem's input needs no gradient): every SimSiam level's loss runs and
# the drawn one is selected, so every decoder stage of every call gets a
# gradient whatever the draw; 9 head forwards and 3 head backwards (x1's
# three masks).  An eval batch runs the 42 forwards and 9 head forwards
# only.  A finetune step (phase 13) runs the model once, at local=True, and
# only its output carries a loss: 14 forwards, 14 dw, 13 dx and 3 head
# forwards, no head backward; a finetune eval batch 14 forwards and 3 head
# forwards.  Which kernel runs the forward and the dx follows PCRL_CONV3D:
FWD_DX = {"pallas": ("conv3d_fwd", "conv3d_fwd"),
          "packed": ("conv3d_packed", "conv3d_packed"),
          "im2col": ("conv3d_im2col", "conv3d_fwd")}


def expected_launches(selector: str, steps: int, eval_batches: int,
                      finetune: bool = False) -> dict:
    """The counts a run of ``steps`` train steps and ``eval_batches`` eval
    batches must show (a graph replay adds its capture's counts), pretask
    or (``finetune``) finetune."""
    calls = 1 if finetune else 3  # model calls a step: the volume, or x1, x2, locals
    expect = {k: 0 for k in KERNELS}
    expect.update(conv3d_dw=14 * calls * steps, head_fwd=3 * calls * (steps + eval_batches),
                  head_bwd=0 if finetune else 3 * steps)
    fwd, dx = FWD_DX[selector]
    expect[fwd] += 14 * calls * (steps + eval_batches)
    expect[dx] += 13 * calls * steps
    return expect


# (run name, PCRL_CONV3D, --amp) of phases 6 and 7
RUNS = [("f32", "pallas", False), ("amp", "pallas", True),
        ("packed", "packed", False), ("im2col", "im2col", False),
        ("packed_amp", "packed", True), ("im2col_amp", "im2col", True)]
#: the run whose count is each kernel's ``launches`` in the kernels line
LAUNCHED_IN = {"conv3d_fwd": "f32", "conv3d_dw": "f32", "head_fwd": "f32",
               "head_bwd": "f32", "conv3d_im2col": "im2col", "conv3d_packed": "packed"}


def level_shape(call: str, level: int, calls=CALLS):
    b, size = calls[call]
    return (b,) + tuple(s >> level for s in size)


def time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def conv_cases(dtype, calls=CALLS):
    """(kernel, label, kernel_fn, plain_fn, library_fn, flops, bytes, kinds)
    for every conv launch shape of one training step (of ``calls``' model
    calls); ``kinds`` names each output's tolerance class."""
    import torch
    import torch.nn.functional as F

    from pcrlv2_tpu_torch.ops import conv3d_kernel as ck
    from pcrlv2_tpu_torch.ops import conv3d_packed as cp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    es = torch.tensor([], dtype=dtype).element_size()
    for call in calls:
        for name, ci, co, level in CONVS:
            shp = level_shape(call, level, calls)
            m = math.prod(shp)
            x = (torch.randn(shp + (ci,), generator=gen, device=dev) * 0.5).to(dtype)
            g = (torch.randn(shp + (co,), generator=gen, device=dev) * 0.5).to(dtype)
            w = ((torch.rand(co, ci, 3, 3, 3, generator=gen, device=dev) * 2 - 1)
                 / math.sqrt(27 * ci))
            wm, wt = ck.repack_weight(w, dtype), ck.flipped_weight(w, dtype)
            bias = (torch.rand(co, generator=gen, device=dev) - 0.5).to(dtype)
            x_nc, g_nc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            w_nc = w.to(dtype)
            flops = 2.0 * m * 27 * ci * co

            def lib_bwd(mask, x_nc=x_nc, g_nc=g_nc, w_nc=w_nc):
                return torch.ops.aten.convolution_backward(
                    g_nc, x_nc, w_nc, None, [1] * 3, [1] * 3, [1] * 3, False,
                    [0] * 3, 1, mask)

            label = f"{call} {name} {tuple(shp)} {ci}->{co}"
            fwd_bytes = es * (m * (ci + co) + 27 * ci * co + co)
            dx_bytes = es * (m * (ci + co) + 27 * ci * co)
            for kernel, kfn, pfn, dx in [
                    ("conv3d_fwd", ck.conv3d_fwd, ck.conv3d_fwd_plain, True),
                    ("conv3d_packed", cp.conv3d_packed_fwd, cp.conv3d_packed_plain, True),
                    ("conv3d_im2col", cp.conv3d_im2col_fwd, cp.conv3d_im2col_plain, False)]:
                yield (kernel, label + " fwd",
                       lambda x=x, wm=wm, bias=bias, f=kfn: f(x, wm, bias),
                       lambda x=x, wm=wm, bias=bias, f=pfn: f(x, wm, bias),
                       lambda x_nc=x_nc, w_nc=w_nc, bias=bias: F.conv3d(x_nc, w_nc, bias,
                                                                        padding=1),
                       flops, fwd_bytes, ("out",))
                # the stem's input needs no gradient; im2col's dx is #1's
                if dx and name != "down_tr64.ops.0":
                    yield (kernel, label + " dx",
                           lambda g=g, wt=wt, f=kfn: f(g, wt, None),
                           lambda g=g, wt=wt, f=pfn: f(g, wt, None),
                           lambda f=lib_bwd: f([True, False, False]),
                           flops, dx_bytes, ("out",))
            yield ("conv3d_dw", label + " dw",
                   lambda x=x, g=g: ck.conv3d_dw(x, g),
                   lambda x=x, g=g: ck.conv3d_dw_plain(x, g),
                   lambda f=lib_bwd: f([False, True, False]),
                   flops, es * m * (ci + co) + 4 * 27 * ci * co, ("dw",))


def head_cases(dtype, calls=CALLS):
    import torch
    import torch.nn.functional as F

    from pcrlv2_tpu_torch.ops import head_conv as hc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    es = torch.tensor([], dtype=dtype).element_size()
    for call in calls:
        for name, ci, level in HEADS:
            shp = level_shape(call, level, calls)
            m = math.prod(shp)
            x = (torch.randn(shp + (ci,), generator=gen, device=dev) * 0.5).to(dtype)
            g = (torch.randn(shp, generator=gen, device=dev) * 0.5).to(dtype)
            w = (torch.rand(1, ci, 3, 3, 3, generator=gen, device=dev) * 2 - 1) / math.sqrt(27 * ci)
            k = hc.flatten_kernel(w, dtype)
            x_nc, w_nc = x.permute(0, 4, 1, 2, 3), w.to(dtype)
            label = f"{call} {name} {tuple(shp)} {ci}->1"
            yield ("head_fwd", label + " fwd",
                   lambda x=x, k=k: hc.head_fwd(x, k),
                   lambda x=x, k=k: hc.head_fwd_plain(x, k),
                   lambda x_nc=x_nc, w_nc=w_nc: F.conv3d(x_nc, w_nc, padding=1),
                   2.0 * m * 27 * ci, es * (m * (ci + 1) + 27 * ci), ("out",))
            if call == "global":  # only x1's selected mask gets a gradient
                g_nc = g[:, None]
                yield ("head_bwd", label + " bwd",
                       lambda x=x, g=g, k=k: hc.head_bwd(x, g, k),
                       lambda x=x, g=g, k=k: hc.head_bwd_plain(x, g, k),
                       lambda x_nc=x_nc, g_nc=g_nc, w_nc=w_nc: torch.ops.aten.convolution_backward(
                           g_nc, x_nc, w_nc, None, [1] * 3, [1] * 3, [1] * 3, False,
                           [0] * 3, 1, [True, True, False]),
                       4.0 * m * 27 * ci, es * (2 * m * ci + m + 27 * ci) + 4 * 27 * ci,
                       ("out", "dw"))


# (B, D, H, W, Ci, Co) of phase 5's shapes off the main path: every Ci and
# Co of the set, W = 1, odd W, planes of 1..63 voxels and one of 70.
ODD_SHAPES = [(2, 3, 5, 1, 1, 5), (1, 4, 7, 3, 2, 70), (2, 3, 6, 5, 3, 5),
              (1, 2, 70, 1, 17, 70), (3, 2, 2, 2, 17, 5), (1, 3, 7, 9, 2, 5),
              (2, 2, 3, 3, 1, 70), (1, 5, 9, 7, 3, 70)]


def odd_cases(dtype):
    """(kernel, label, kernel_fn, plain_fn) at ``ODD_SHAPES``: #6 forward
    and dx, #5 forward, #1 forward and dx and #2, every one through its
    route (padded channels where the copies cannot take them)."""
    import torch

    from pcrlv2_tpu_torch.ops import conv3d_kernel as ck
    from pcrlv2_tpu_torch.ops import conv3d_packed as cp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for shp in ODD_SHAPES:
        ci, co = shp[4:]
        x = (torch.randn(shp[:4] + (ci,), generator=gen, device=dev) * 0.5).to(dtype)
        g = (torch.randn(shp[:4] + (co,), generator=gen, device=dev) * 0.5).to(dtype)
        w = (torch.rand(co, ci, 3, 3, 3, generator=gen, device=dev) * 2 - 1) / math.sqrt(27 * ci)
        wm, wt = ck.repack_weight(w, dtype), ck.flipped_weight(w, dtype)
        bias = (torch.rand(co, generator=gen, device=dev) - 0.5).to(dtype)
        label = f"{shp[:4]} {ci}->{co} ({ck.route(ci, co, dtype)} / {cp.route(ci, co, dtype)})"
        for kernel, kfn, pfn in [("conv3d_fwd", ck.conv3d_fwd, ck.conv3d_fwd_plain),
                                 ("conv3d_packed", cp.conv3d_packed_fwd, cp.conv3d_packed_plain),
                                 ("conv3d_im2col", cp.conv3d_im2col_fwd, cp.conv3d_im2col_plain)]:
            yield (kernel, label + " fwd", lambda x=x, wm=wm, bias=bias, f=kfn: f(x, wm, bias),
                   lambda x=x, wm=wm, bias=bias, f=pfn: f(x, wm, bias), "out")
            if kernel != "conv3d_im2col":
                yield (kernel, label + " dx", lambda g=g, wt=wt, f=kfn: f(g, wt, None),
                       lambda g=g, wt=wt, f=pfn: f(g, wt, None), "out")
        yield ("conv3d_dw", label + " dw", lambda x=x, g=g: ck.conv3d_dw(x, g),
               lambda x=x, g=g: ck.conv3d_dw_plain(x, g), "dw")


# (B, D, H, W, Ci) of phase 5's head shapes off the main path: Ci of 1, 3, 17
# and 70 (padded route) and 64, W = 1, odd W (33: a tile past the plane's
# edge), a plane of 70, D < 3.
HEAD_ODD_SHAPES = [(2, 3, 5, 1, 1), (1, 2, 7, 10, 3), (2, 1, 6, 5, 17),
                   (1, 4, 70, 1, 70), (3, 2, 3, 9, 70), (1, 3, 5, 33, 64)]


def head_odd_cases(dtype):
    """(kernel, label, kernel_fn, plain_fn, kinds) at ``HEAD_ODD_SHAPES``: #3
    forward and #4 backward, each through its route."""
    import torch

    from pcrlv2_tpu_torch.ops import head_conv as hc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for shp in HEAD_ODD_SHAPES:
        ci = shp[4]
        x = (torch.randn(shp, generator=gen, device=dev) * 0.5).to(dtype)
        g = (torch.randn(shp[:4], generator=gen, device=dev) * 0.5).to(dtype)
        w = (torch.rand(1, ci, 3, 3, 3, generator=gen, device=dev) * 2 - 1) / math.sqrt(27 * ci)
        k = hc.flatten_kernel(w, dtype)
        label = f"{shp[:4]} {ci}->1 ({hc.route(ci, dtype)})"
        yield ("head_fwd", label + " fwd", lambda x=x, k=k: hc.head_fwd(x, k),
               lambda x=x, k=k: hc.head_fwd_plain(x, k), ("out",))
        yield ("head_bwd", label + " bwd", lambda x=x, g=g, k=k: hc.head_bwd(x, g, k),
               lambda x=x, g=g, k=k: hc.head_bwd_plain(x, g, k), ("out", "dw"))


def check_odd_shapes(case_fns=(odd_cases, head_odd_cases)):
    """Phase 5, the shapes off the main path: every case of ``odd_cases``
    and ``head_odd_cases`` (phase 9: of ``tool_odd_cases``) within ``TOL`` of
    its plain version, with the output's shape and dtype, in f32 and bf16.
    Returns one row per case."""
    import torch

    rows, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for kernel, label, kfn, pfn, kinds in itertools.chain(*(f(dtype) for f in case_fns)):
            got, ref = kfn(), pfn()
            torch.cuda.synchronize()
            kinds = kinds if isinstance(kinds, tuple) else (kinds,)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            errs = [rel_err(a, r) for a, r in zip(got, ref)]
            rel, err = max(e[0] for e in errs), max(e[1] for e in errs)
            ok = all(a.shape == r.shape and a.dtype == r.dtype and e[0] <= TOL[(dname, kd)]
                     for a, r, e, kd in zip(got, ref, errs, kinds))
            rows.append({"kernel": kernel, "case": label, "dtype": dname, "rel_err": rel,
                         "max_abs_err": err, "ok": ok})
            if not ok:
                failures.append(f"{dname} {kernel} {label}: rel err "
                                f"{[e[0] for e in errs]}, shapes "
                                f"{[tuple(a.shape) for a in got]} vs "
                                f"{[tuple(r.shape) for r in ref]}")
    if failures:
        raise AssertionError("odd shapes:\n  " + "\n  ".join(failures))
    return rows


def in_channels_check(in_channels: int = 2):
    """Phase 5, ``PCRLv23d(in_channels=2)``: the f32 train-mode forward on the
    card within 1e-4 of the CPU's on the same weights, then one train step
    on the card under each ``PCRL_CONV3D`` value (every 3³ conv kernel of the
    selector launched, losses and parameters finite, parameters moved)."""
    import torch

    from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.step import TrainState, train_step

    rng = torch.Generator().manual_seed(9)
    x = torch.rand(2, 16, 16, 8, in_channels, generator=rng)

    def forward(device):
        model = PCRLv23d(policy=PARITY_POLICY, in_channels=in_channels, seed=4, device=device)
        with torch.no_grad():
            out, _, masks = model(x.to(device))
        return [v.float().cpu() for v in (out, *masks)]

    err = max((a - b).abs().max().item() for a, b in zip(forward("cuda"), forward("cpu")))
    if not err <= 1e-4:
        raise AssertionError(f"in_channels={in_channels}: card vs CPU forward {err:.3e} > 1e-4")
    views = {"x1": x, "x2": torch.rand(x.shape, generator=rng),
             "gt": torch.rand(x.shape[:-1] + (1,), generator=rng),
             "locals": torch.rand((2, 2, 8, 8, 8, in_channels), generator=rng)}
    views = {k: v.cuda() for k, v in views.items()}
    steps = {}
    for selector, (fwd, _) in FWD_DX.items():
        model = PCRLv23d(in_channels=in_channels, seed=4, device="cuda")
        before = [p.detach().clone() for p in model.parameters()]
        state = TrainState(model)
        with env_var("PCRL_CONV3D", selector):
            _build.launches.clear()
            metrics = train_step(state, views, [0, 1, 2, 0, 1], lr=0.1, epoch=0)
            torch.cuda.synchronize()
        counts = {k: _build.launches[k] for k in KERNELS}
        loss = float(metrics["loss"])
        moved = any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
        finite = all(torch.isfinite(p).all().item() for p in model.parameters())
        if not (math.isfinite(loss) and not metrics["skipped"] and moved and finite
                and counts[fwd] > 0 and counts["conv3d_dw"] > 0):
            raise AssertionError(f"in_channels={in_channels} step under {selector}: loss {loss}, "
                                 f"skipped {metrics['skipped']}, moved {moved}, finite "
                                 f"{finite}, launches {counts}")
        steps[selector] = {"loss": loss, "launches": counts}
    return {"f32_forward_max_abs_err": err, "steps": steps}


def spills(report: dict) -> dict:
    """Kernels whose ``-Xptxas -v`` report shows spill stores or loads:
    {source: {kernel (mangled): (store bytes, load bytes)}}."""
    out = {}
    for name, (_, log) in report.items():
        fn = None
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill stores" in line and fn is not None:
                nums = [int(t) for t in line.replace(",", " ").split() if t.isdigit()]
                if len(nums) >= 3 and (nums[1] or nums[2]):
                    out.setdefault(name, {})[fn] = (nums[1], nums[2])
    return out


def rel_err(got, ref):
    """(max |got − ref| / max |ref|, max |got − ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err / max(ref.float().abs().max().item(), 1e-30), err


def check_and_time(results):
    """Phases 3 and 4: every kernel against its plain version at every shape,
    in f32 and bf16; kernel, bound and library times in both dtypes, the
    plain version's in f32.  A kernel's summary sums one launch at each of
    its main-path shapes, per dtype (the bf16 sums under ``bf16_*`` keys)."""
    import torch

    keys = ("ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms")
    summary = {k: {"max_abs_err": 0.0, "plain_ms": 0.0, "shapes": 0,
                   "bf16_max_abs_err": 0.0, "bf16_shapes": 0,
                   **{key: 0.0 for key in keys}, **{"bf16_" + key: 0.0 for key in keys}}
               for k in KERNELS}
    failures = []
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        pre = "" if dtype == torch.float32 else "bf16_"
        for case_fn in (conv_cases, head_cases):
            for kernel, label, kfn, pfn, lfn, flops, nbytes, kinds in case_fn(dtype):
                got, ref = kfn(), pfn()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                errs = [rel_err(a, b) for a, b in zip(got, ref)]
                tols = [TOL[(dname, kind)] for kind in kinds]
                ok = all(e[0] <= t for e, t in zip(errs, tols))
                rel = max(e[0] / t for e, t in zip(errs, tols))  # share of its tolerance
                err = max(e[1] for e in errs)
                del got, ref
                row = {"kernel": kernel, "case": label, "dtype": dname,
                       "rel_err": [e[0] for e in errs], "tol": tols,
                       "max_abs_err": err, "ok": ok, "ms": time_ms(kfn),
                       "library_ms": time_ms(lfn),
                       "ops_ms": 1e3 * flops / PEAK_FLOPS[dname],
                       "bytes_ms": 1e3 * nbytes / HBM_BYTES_S}
                row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
                s = summary[kernel]
                if dname == "float32":
                    row["plain_ms"] = time_ms(pfn, reps=2)
                    s["plain_ms"] += row["plain_ms"]
                s[pre + "max_abs_err"] = max(s[pre + "max_abs_err"], err)
                for key in keys:
                    s[pre + key] += row[key]
                s[pre + "shapes"] += 1
                results.append(row)
                worst[dname] = max(worst.get(dname, 0.0), rel)
                if not ok:
                    failures.append(f"{dname} {label}: rel err {row['rel_err']} > {tols}")
        print(f"  {dname}: {sum(r['dtype'] == dname for r in results)} launches checked, "
              f"largest error {worst[dname]:.2f} of its tolerance", flush=True)
    for name, s in summary.items():
        print(f"  {name}: f32 {s['ms']:.3f} ms (bound {s['bound_ms']:.3f}, cuDNN "
              f"{s['library_ms']:.3f}, plain {s['plain_ms']:.3f}); bf16 {s['bf16_ms']:.3f} ms "
              f"(bound {s['bf16_bound_ms']:.3f}, cuDNN {s['bf16_library_ms']:.3f}) over "
              f"{s['shapes']} shapes", flush=True)
    return summary, failures


def model_reference_check():
    """Phase 5: a small train-mode forward (output and the 3 masks) on the
    card (kernels) against the same weights on the CPU (plain versions).

    f32 (``PARITY_POLICY``): within 1e-4.  bf16 (``DEFAULT_POLICY``, what
    ``--amp`` runs): both sides round every layer's activations to bf16 but
    sum in other orders, so roundings flip here and there and the flips
    compound over 20 layers; neither bf16 run is the other's reference.  The
    card's bf16 forward must be no farther from the CPU's f32 forward than
    1.5× the CPU's own bf16 forward is, plus 2^-8 (one bf16 rounding) of the
    largest entry: the rule ``tests/test_torch_model.py::
    test_bf16_policy_forward_matches_jax`` holds the port's bf16 path to on
    the CPU against the JAX package.  Returns the f32 error and, per output,
    the bf16 distances relative to the largest entry."""
    import torch

    from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d

    x = torch.rand(2, 16, 16, 8, 1, generator=torch.Generator().manual_seed(6))

    def forward(policy, device):
        model = PCRLv23d(policy=policy, seed=5, device=device)
        with torch.no_grad():
            out, _, masks = model(x.to(device))
        return [v.float().cpu() for v in (out, *masks)]

    f32_card, f32_cpu = forward(PARITY_POLICY, "cuda"), forward(PARITY_POLICY, "cpu")
    errs = [(a - b).abs().max().item() for a, b in zip(f32_card, f32_cpu)]
    if max(errs) > 1e-4 or not all(math.isfinite(e) for e in errs):
        raise AssertionError(f"model on the card vs CPU: max err {max(errs):.3e} > 1e-4")
    bf16_card, bf16_cpu = forward(DEFAULT_POLICY, "cuda"), forward(DEFAULT_POLICY, "cpu")
    bf16 = {}
    for name, card, cpu, ref in zip(("out", "mask0", "mask1", "mask2"),
                                    bf16_card, bf16_cpu, f32_cpu):
        scale = ref.abs().max().item()
        err = (card - ref).abs().max().item() / scale
        limit = 1.5 * (cpu - ref).abs().max().item() / scale + 2.0 ** -8
        bf16[name] = {"card_vs_cpu_f32": err, "limit": limit,
                      "cpu_bf16_vs_cpu_f32": (cpu - ref).abs().max().item() / scale,
                      "card_vs_cpu_bf16": (card - cpu).abs().max().item() / scale}
        if not err <= limit:
            raise AssertionError(f"bf16 model on the card, {name}: {err:.3e} of the largest "
                                 f"entry from the CPU's f32 forward, limit {limit:.3e}")
    return max(errs), bf16


def cli_argv(amp: bool, out_dir: str, steps: int, log_every: int = 1):
    return (["--synthetic", "--d", "3", "--phase", "pretask", "--b", str(BATCH),
             "--epochs", "0", "--steps_per_epoch", str(steps), "--log_every", str(log_every),
             "--seed", "0", "--output", out_dir] + (["--amp"] if amp else []))


@contextlib.contextmanager
def env_var(name: str, value: str):
    """``name=value`` in the environment for the duration."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def launched(selector: str, steps: int, eval_batches: int, what: str,
             finetune: bool = False) -> dict:
    """The launch counters against ``expected_launches``."""
    from pcrlv2_tpu_torch.ops import _build

    counts = {k: _build.launches[k] for k in KERNELS}
    expect = expected_launches(selector, steps, eval_batches, finetune)
    if counts != expect:
        raise AssertionError(f"{what}: launches {counts}, expected {expect}")
    return counts


def step_rows(metrics_path: str, epoch: int = 0):
    rows = [json.loads(s) for s in open(metrics_path)]
    steps = [r for r in rows if "iter" in r and r["epoch"] == epoch]
    for r in steps:
        for k in ("loss", "mg_loss", "cos_loss", "local_loss"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"non-finite {k} at step {r['iter']}: {r[k]}")
        if r["skipped"]:
            raise AssertionError(f"step {r['iter']} was skipped by the loss guard")
    return rows, steps


def step_times(steps) -> list:
    """Each logged window's own mean step time from the running average
    ``BT`` (at --log_every 1, each step's own time)."""
    avg = [r["BT"] for r in steps]
    return [avg[0]] + [(k + 1) * avg[k] - k * avg[k - 1] for k in range(1, len(avg))]


def run_cli(selector: str, amp: bool, out_dir: str, steps: int = STEPS, log_every: int = 1,
            cuda_graph: bool = True, extra=()):
    """Phase 6: the port's CLI in this process, counters read around it; with
    ``cuda_graph=False`` the same path (``cli.main.prepare`` →
    ``run_training``) on the eager loop.  At ``log_every`` > 1 the logged
    rows are windows: ``step_s`` then holds each window's mean step time and
    the step time is the mean of windows 2-3.  ``extra``: more CLI flags
    (phase 11)."""
    import torch

    from pcrlv2_tpu_torch.cli.main import main as cli_main
    from pcrlv2_tpu_torch.cli.main import prepare
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.checkpoint import import_pcrlv23d
    from pcrlv2_tpu_torch.train.trainer import run_training

    argv = cli_argv(amp, out_dir, steps, log_every) + list(extra)
    allocated_before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    with env_var("PCRL_CONV3D", selector):
        _build.launches.clear()
        t0 = time.perf_counter()
        if cuda_graph:
            trainer = cli_main(argv)
        else:
            model, cfg, loaders, aug_fn, device = prepare(argv)
            trainer = run_training(model, cfg, loaders["train"], aug_fn, device,
                                   cuda_graph=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launched(selector, steps, 0, f"CLI under {selector}{' --amp' if amp else ''}"
                          f"{'' if cuda_graph else ' (eager)'}")
    _, rows = step_rows(os.path.join(out_dir, "metrics.jsonl"))
    if len(rows) != steps // log_every:
        raise AssertionError(f"expected {steps // log_every} logged rows, got {len(rows)}")
    fresh = PCRLv23d(device="cuda", seed=1)
    import_pcrlv23d(os.path.join(out_dir, "pcrlv2_luna_pretask_1.0_0.pt"), fresh)
    step_s = step_times(rows)
    typical = (statistics.median(step_s[WARMUP:]) if log_every == 1
               else statistics.mean(step_s[1:3]))
    captured = trainer.captured
    return {"counts": counts, "wall_s": wall, "log_every": log_every, "step_s": step_s,
            "step_s_median": typical, "cuda_graph": cuda_graph,
            "graphs": 0 if captured is None else len(captured.graphs),
            "capture_s": [] if captured is None else list(captured.capture_s.values()),
            "dt_s": [r["DT"] for r in rows],
            "losses": [r["loss"] for r in rows],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "allocated_gib_before": allocated_before}


def sync_free_step() -> dict:
    """Phase 6: one ``train_step`` at full width on device-resident views,
    after a warm-up step, under ``torch.cuda.set_sync_debug_mode("error")``:
    any synchronising call inside the step raises.  The mode is reset after."""
    import torch

    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.train.step import TrainState, train_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    size = CALLS["global"][1]
    views = {"x1": torch.rand((BATCH,) + size + (1,), generator=gen, device=dev),
             "x2": torch.rand((BATCH,) + size + (1,), generator=gen, device=dev),
             "gt": torch.rand((BATCH,) + size + (1,), generator=gen, device=dev),
             "locals": torch.rand((BATCH, 6) + CALLS["local"][1] + (1,), generator=gen,
                                  device=dev)}
    state = TrainState(PCRLv23d(device="cuda", seed=7))
    # 1 + 2·V levels for V = 6 local views, lr and epoch on the device, as
    # the trainer passes them
    levels = torch.arange(1 + 2 * 6, device=dev) % 3
    lr = torch.full((), 1e-3, device=dev)
    epoch = torch.zeros((), dtype=torch.int64, device=dev)
    train_step(state, views, levels, lr, epoch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = train_step(state, views, levels, lr, epoch)
        host_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    loss, skipped, step = float(metrics["loss"]), float(metrics["skipped"]), int(state.step)
    if not (math.isfinite(loss) and skipped == 0.0 and step == 2):
        raise AssertionError(f"sync-free step: loss {loss}, skipped {skipped}, step {step}")
    return {"loss": loss, "host_s": host_s, "device_s": time.perf_counter() - t0}


def native_reader(loaders: dict):
    """The train loader's native batch reader; fails if the CLI took the
    NumPy reader (the library's build error in the message)."""
    from pcrlv2_tpu_torch import native

    reader = loaders["train"].batch_read_fn
    if reader is None:
        raise AssertionError("the CLI read the tree through NumPy: the native library did "
                             f"not load ({native.build_error()})")
    return reader


def reader_identity(argv) -> int:
    """Phase 8: one epoch of the CLI's train loader through the native
    reader against the same loader through ``load_luna_sample``, bit for
    bit; returns the batches compared."""
    import numpy as np

    from pcrlv2_tpu_torch.cli.main import prepare
    from pcrlv2_tpu_torch.data.pipeline import HostLoader

    loaders = prepare(argv)[2]
    train = loaders["train"]
    reader = native_reader(loaders)
    plain = HostLoader(train.paths, train.batch_size, train.read_fn, shuffle=train.shuffle,
                       seed=train.seed, num_workers=train.num_workers)
    got, want = list(train.epoch(0)), list(plain.epoch(0))
    if len(got) != len(want) or reader.batches != len(got) or not all(
            a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                                         for k in a) for a, b in zip(got, want)):
        raise AssertionError(f"native reader: {len(got)} batches ({reader.batches} served) "
                             f"differ from the NumPy reader's {len(want)}")
    return len(got)


def run_disk(tmp: str):
    """Phase 8: the CLI's path (``prepare`` → ``run_training``) on a
    processed tree under ``packed``, through the native reader: train,
    eval, save, then resume from the saved train state."""
    import torch

    from pcrlv2_tpu_torch.cli.main import prepare
    from pcrlv2_tpu_torch.data.pipeline import write_synthetic_luna_tree
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.checkpoint import import_pcrlv23d
    from pcrlv2_tpu_torch.train.trainer import run_training

    tree, out = os.path.join(tmp, "tree"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    write_synthetic_luna_tree(tree, n_subsets=10, uids_per_subset=2, pairs_per_uid=3)
    write_s = time.perf_counter() - t0
    argv = disk_argv(tree, out)
    compared = reader_identity(argv + ["--epochs", "1"])
    state_dir = os.path.join(out, "train_state")
    # 42 train crops: 10 steps per epoch; the resumed run trains epoch 2 only
    counts, served, runs = [], [], [(argv + ["--epochs", "1"], 2),
                                    (argv + ["--epochs", "2", "--resume", state_dir], 1)]
    with env_var("PCRL_CONV3D", "packed"):
        for run_argv, epochs in runs:
            model, cfg, loaders, aug_fn, device = prepare(run_argv)
            reader = native_reader(loaders)
            _build.launches.clear()
            run_training(model, cfg, loaders["train"], aug_fn, device,
                         eval_loader=loaders["eval"])
            torch.cuda.synchronize()
            counts.append(launched("packed", STEPS * epochs, 2 * epochs,
                                   "disk CLI under packed"))
            served.append(reader.batches)
            if reader.batches != STEPS * epochs:
                raise AssertionError(f"the native reader served {reader.batches} of "
                                     f"{STEPS * epochs} train batches")
    rows = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl"))]
    per_epoch = {e: step_rows(os.path.join(out, "metrics.jsonl"), e)[1] for e in (0, 1, 2)}
    if [len(v) for v in per_epoch.values()] != [STEPS] * 3:
        raise AssertionError(f"steps per epoch {[len(v) for v in per_epoch.values()]}")
    evals = [r for r in rows if "eval" in r]
    if [r["epoch"] for r in evals] != [0, 1, 2] or not all(
            math.isfinite(v) for r in evals for v in r["eval"].values()):
        raise AssertionError(f"eval rows {evals}")
    state = torch.load(os.path.join(state_dir, "state.pt"), weights_only=True)
    if (state["epoch"], state["step"]) != (2, 3 * STEPS):
        raise AssertionError(f"train state at epoch {state['epoch']} step {state['step']}")
    import_pcrlv23d(os.path.join(out, "pcrlv2_luna_pretask_1.0_0.pt"),
                    PCRLv23d(device="cuda", seed=1))
    step_s = step_times(per_epoch[0])
    return {"tree_write_s": write_s, "counts": counts, "step_s": step_s,
            "reader_batches_compared": compared, "reader_batches_served": served,
            "step_s_median": statistics.median(step_s[WARMUP:]),
            "dt_s": [r["DT"] for r in per_epoch[0]],
            "epoch0_data_time_s": next(r["data_time"] for r in rows
                                       if r.get("epoch") == 0 and "epoch_time" in r),
            "evals": [r["eval"] for r in evals], "tree": tree}


def disk_argv(tree: str, out: str):
    return ["--data", tree, "--d", "3", "--n", "luna", "--phase", "pretask",
            "--b", str(BATCH), "--eval_every", "1", "--eval_batches", "2",
            "--save_every", "1", "--log_every", "1", "--seed", "0", "--output", out]


def _kernel_us(evt) -> float:
    """Device time of a device-kernel entry; 0 for host-side ops (an autograd
    op's entry also carries the time of the kernels it launched)."""
    from torch.autograd import DeviceType

    if getattr(evt, "device_type", None) != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_cli(argv, step_s: float, cuda_graph: bool = True, groups=GROUPS):
    """Phase 7: the CLI's training path under ``torch.profiler``: the
    ``Trainer`` that ``run_training`` builds (on the graph path, or eager
    with ``cuda_graph=False``), or for ``--phase finetune`` the
    ``FinetuneTrainer`` that ``run_finetune`` builds (phase 13), fed through
    ``device_prefetch``; each batch's fetch is marked (after a device sync).
    The pretask trainer fetches a batch before the step that augments it, so
    profiler period k ≥ 2 holds step k − 2 (a finetune step k − 1): the
    schedule waits out the first augmentation and ``WARMUP`` steps (the
    graph's capture among them) and records the ``PROFILED`` steps after
    them; ``argv`` must give ``PROFILE_STEPS`` batches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from pcrlv2_tpu_torch.cli.main import prepare, prepare_finetune
    from pcrlv2_tpu_torch.data.pipeline import device_prefetch
    from pcrlv2_tpu_torch.train.finetune import FinetuneTrainer
    from pcrlv2_tpu_torch.train.trainer import Trainer

    if "finetune" in argv:
        cfg, loaders, device, options = prepare_finetune(argv)
        trainer = FinetuneTrainer(cfg, device=device, cuda_graph=cuda_graph, **options)
    else:
        model, cfg, loaders, aug_fn, device = prepare(argv)
        trainer = Trainer(model, cfg, aug_fn, device, cuda_graph=cuda_graph)

    def marked(batches):
        for batch in batches:
            torch.cuda.synchronize()
            prof.step()
            yield batch

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=WARMUP + 1, warmup=1, active=PROFILED,
                                       repeat=1)) as prof:
            with contextlib.closing(device_prefetch(
                    loaders["train"].epoch(0), device)) as batches:
                trainer.train_epoch(0, marked(batches))
    finally:
        trainer.logger.close()
    events = prof.key_averages()
    # the profiler's own step annotation also shows as a device entry
    kernels = [(e.key, _kernel_us(e), e.count) for e in events
               if _kernel_us(e) > 0 and not e.key.startswith("ProfilerStep")]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernel")
    # the host's CUDA API calls: cudaLaunchKernel (eager launches, ours and
    # PyTorch's) against cudaGraphLaunch (a replay), copies and the rest
    api = {e.key: e.count / PROFILED for e in events
           if _kernel_us(e) == 0 and re.match(r"cu(da)?[A-Z]", e.key)}
    busy_ms = sum(us for _, us, _ in kernels) / 1e3 / PROFILED
    by_group = {label: 0.0 for _, label in groups}
    by_group["other"] = 0.0
    for name, us, _ in kernels:
        label = next((lab for frag, lab in groups if frag in name.lower()), "other")
        by_group[label] += us / 1e3 / PROFILED
    # #5's and #6's kernels by name: bf16 runs must show their mma kernels
    slab = sorted({m.group(0) for n, _, _ in kernels
                   for m in [re.search(r"conv3d_(packed|im2col)_kernel_\w+(<[^>]*>)?", n)] if m})
    return {"device_ms_per_step": busy_ms, "busy_share": busy_ms / 1e3 / step_s,
            "launches_per_step": sum(c for _, _, c in kernels) / PROFILED,
            "host_api_per_step": api,
            "kernel_launch_calls_per_step": sum(v for k, v in api.items()
                                                if "LaunchKernel" in k),
            "graph_launches_per_step": api.get("cudaGraphLaunch", 0.0),
            "cuda_graph": cuda_graph,
            "ms_per_step_by_group": by_group, "slab_kernels": slab,
            "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / PROFILED,
                             "launches_per_step": c / PROFILED}
                            for n, us, c in sorted(kernels, key=lambda k: -k[1])[:15]]}


def print_profile(name: str, p: dict):
    print(f"[7] profile {name}: device {p['device_ms_per_step']:.2f} ms/step, "
          f"busy {p['busy_share']:.1%}, {p['launches_per_step']:.1f} device kernels "
          f"a step; host API a step: {p['kernel_launch_calls_per_step']:.1f} kernel launch "
          f"calls, {p['graph_launches_per_step']:.1f} graph launches; " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(
                  p["ms_per_step_by_group"].items(), key=lambda kv: -kv[1]) if v)
          + (f"; #5/#6 kernels {p['slab_kernels']}" if p["slab_kernels"] else ""),
          flush=True)


def run_tools() -> dict:
    """Phase 9, the tool runs: each tool's ``main()`` on the card at the JAX
    tools' shapes, the launch counters set to 0 just before and read just
    after.  Any probe FAIL or kernel of the tools left unlaunched fails."""
    import torch

    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.tools import probe_mosaic, proto_co1_kernel, proto_conv

    _build.launches.clear()
    t0 = time.perf_counter()
    rows = {"proto_conv": proto_conv.main(), "proto_co1_kernel.main": proto_co1_kernel.main(),
            "proto_co1_kernel.main2": proto_co1_kernel.main2()}
    failures = probe_mosaic.main()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: _build.launches[k] for k in TOOL_KERNELS}
    if failures:
        raise AssertionError(f"probe_mosaic: {failures} probes FAIL")
    if not all(counts.values()):
        raise AssertionError(f"tool runs left kernels unlaunched: {counts}")
    return {"counts": counts, "rows": rows, "wall_s": wall}


def tool_cases(dtype, batch: int):
    """The tools' cases: #7's and #8/#9's at every tool shape, and the 14
    probes of #10 (once, in the bf16 pass: they fix their own dtypes)."""
    import torch

    from pcrlv2_tpu_torch.tools import probe_mosaic, proto_co1_kernel, proto_conv

    dev = torch.device("cuda")
    yield from proto_conv.cases(dev, batch, dtype)
    yield from proto_co1_kernel.cases(dev, batch, dtype)
    if dtype == torch.bfloat16:
        yield from probe_mosaic.cases(dev)


def check_and_time_tools(results):
    """Phase 9, the checks: every tool kernel against its plain version at
    every tool shape (the probes with tolerance 0), bf16 at B = 32 and f32
    at ``TOOL_F32_BATCH``, both timed (kernel, plain, PyTorch call).  A
    kernel's summary sums one launch at each of its B = 32 shapes; its f32
    sums at ``TOOL_F32_BATCH`` are under ``f32_*`` keys.  ``product_ops_ms``
    is the formulation's own FLOPs at the peak where they differ from the
    useful ones (#9's banded product), else ``ops_ms``."""
    import torch

    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms", "product_ops_ms")
    summary = {k: {"max_abs_err": 0.0, "shapes": 0, "f32_shapes": 0,
                   **{key: 0.0 for key in keys}, **{"f32_" + key: 0.0 for key in keys}}
               for k in TOOL_KERNELS}
    failures = []
    for dtype, batch in ((torch.bfloat16, 32), (torch.float32, TOOL_F32_BATCH)):
        dname = str(dtype).split(".")[1]
        for case in tool_cases(dtype, batch):
            got, ref = case.run(), case.plain()
            torch.cuda.synchronize()
            rel, err = rel_err(got, ref)
            tol = 0.0 if case.kernel == "probe_mosaic" else TOL[(dname, "out")]
            ok = got.dtype == ref.dtype and got.shape == ref.shape and (
                torch.equal(got, ref) if tol == 0.0 else rel <= tol)
            del got, ref
            row = {"kernel": case.kernel, "case": case.label, "dtype": dname,
                   "batch": batch, "rel_err": rel, "tol": tol, "max_abs_err": err,
                   "ok": ok}
            s = summary[case.kernel]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            io_dtype = dname if case.kernel != "probe_mosaic" else "float32"
            row.update(ms=time_ms(case.run), plain_ms=time_ms(case.plain, reps=2),
                       library_ms=time_ms(case.library),
                       ops_ms=1e3 * case.flops / PEAK_FLOPS[io_dtype],
                       bytes_ms=1e3 * case.nbytes / HBM_BYTES_S,
                       product_ops_ms=1e3 * (case.product_flops or case.flops)
                       / PEAK_FLOPS[io_dtype])
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            pre = "" if batch == 32 else "f32_"
            for key in keys:
                s[pre + key] += row[key]
            s[pre + "shapes"] += 1
            results.append(row)
            if not ok:
                failures.append(f"{dname} B={batch} {case.kernel} {case.label}: "
                                f"rel err {rel:.3e} > {tol}")
        n = sum(r["dtype"] == dname and r["batch"] == batch for r in results)
        print(f"  {dname} B={batch}: {n} tool launches checked", flush=True)
    return summary, failures


def tool_odd_cases(dtype):
    """(kernel, label, kernel_fn, plain_fn, kinds) at ``TOOL_ODD_CONV`` (#7,
    both modes), ``TOOL_ODD_STENCIL`` (#8) and ``TOOL_ODD_BAND`` (#9, on
    random bands: the kernel computes the full product, so any band must
    give the plain version's answer)."""
    import torch

    from pcrlv2_tpu_torch.ops import head_conv as hc
    from pcrlv2_tpu_torch.tools import proto_co1_kernel as co
    from pcrlv2_tpu_torch.tools import proto_conv as pc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    for shp in TOOL_ODD_CONV:
        ci, co_ = shp[4:]
        x = torch.randn(shp[:5], generator=gen, device=dev).to(dtype)
        wm = (torch.randn((27 * ci, co_), generator=gen, device=dev) * 0.1).to(dtype)
        bias = torch.randn((co_,), generator=gen, device=dev).to(dtype)
        label = f"{shp[:4]} {ci}->{co_}"
        for mode in pc.MODES:
            yield (f"proto_conv{mode}", label,
                   lambda x=x, wm=wm, bias=bias, mode=mode: pc.proto_conv(x, wm, bias, mode),
                   lambda x=x, wm=wm, bias=bias, mode=mode: pc.conv_plain(x, wm, bias, mode),
                   "out")
    for shp in TOOL_ODD_STENCIL:
        ci = shp[4]
        x = torch.randn(shp, generator=gen, device=dev).to(dtype)
        w27 = (torch.randn((27, ci), generator=gen, device=dev) * 0.1).to(dtype)
        yield ("proto_co1", f"{shp[:4]} ci={ci} ({hc.route(ci, dtype)})",
               lambda x=x, w27=w27: co.co1_stencil(x, w27),
               lambda x=x, w27=w27: co.co1_plain(x, w27), "out")
    for shp in TOOL_ODD_BAND:
        w, ci = shp[3:]
        x = torch.randn(shp, generator=gen, device=dev).to(dtype)
        bands = (torch.randn((9, (w + 2) * ci, w), generator=gen, device=dev) * 0.1).to(dtype)
        yield ("proto_co1_band", f"{shp[:4]} ci={ci} ({co.band_route(ci, w, dtype)})",
               lambda x=x, bands=bands: co.co1_band(x, bands),
               lambda x=x, bands=bands: co.band_plain(x, bands), "out")


def device_ms(fn, reps: int = PROBE_REPS) -> float:
    """Device-kernel time per call of ``fn`` under ``torch.profiler``, over
    ``reps`` calls after one warm-up call; 0 for a call that launches no
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_kernel_us(e) for e in prof.key_averages()) / 1e3 / reps


def probe_times() -> list:
    """Phase 9, #10's launch path: per probe, the host-inclusive time per
    call (``time_ms``: 5 back-to-back calls between two CUDA events) and
    the device time per call (``device_ms``) of ``probe_mosaic.run``, of the
    probe's PyTorch expression (``plain``) and of ``probe_mosaic.floor``
    (``run``'s path to an empty kernel: the least a call of it costs)."""
    import torch

    from pcrlv2_tpu_torch.tools import probe_mosaic as pm

    rows = []
    for name, out_shape, xs in pm.probes(torch.device("cuda")):
        row = {"probe": name}
        for what, fn in (("kernel", lambda: pm.run(name, out_shape, *xs)),
                         ("expr", lambda: pm.plain(name, *xs)),
                         ("floor", lambda: pm.floor(name, out_shape, *xs))):
            row[what + "_ms"] = time_ms(fn)
            row[what + "_device_ms"] = device_ms(fn)
        rows.append(row)
    return rows


# Phase 10: two epochs of these many batches, eager and replayed; then the
# replay loop's steps under set_sync_debug_mode("error")
GRAPH_EPOCHS = (3, 3)
SYNC_STEPS = 6
# (run name, PCRL_CONV3D, --amp) run on the eager loop too (phases 6 and 7)
EAGER_RUNS = [("f32", "pallas", False), ("amp", "pallas", True),
              ("packed_amp", "packed", True), ("im2col_amp", "im2col", True)]


def graph_batches(seed: int) -> dict:
    """Phase 10's raw batches on the card: {epoch: [batch, ...]}."""
    import torch

    from pcrlv2_tpu_torch.data.pipeline import synthetic_luna_batch

    return {epoch: [{k: torch.from_numpy(v).cuda() for k, v in synthetic_luna_batch(
        BATCH, seed=seed + 10 * epoch + i).items()} for i in range(n)]
            for epoch, n in enumerate(GRAPH_EPOCHS)}


def graph_trainer(amp: bool, out: str, cuda_graph: bool, seed: int = 7, mixup=None,
                  **aug_flags):
    """A trainer at full width from one seed (epochs 0-2 of the cosine LR, so
    epoch 1 runs at another rate than epoch 0); ``mixup`` and ``aug_flags``
    (``make_luna_aug_fn``'s) as the CLI's flags set them (phase 11)."""
    from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.train.trainer import TrainConfig, Trainer

    model = PCRLv23d(policy=DEFAULT_POLICY if amp else PARITY_POLICY, seed=seed, device="cuda")
    cfg = TrainConfig(b=BATCH, epochs=2, lr=1e-2, log_every=100, seed=3, amp=amp, output=out,
                      mixup=mixup)
    return Trainer(model, cfg, make_luna_aug_fn(**aug_flags), "cuda", cuda_graph=cuda_graph)


def run_epochs(trainer, batches: dict, what: str, dim: int = 3, finetune: bool = False):
    """``trainer.train_epoch`` over ``batches``; every step's metrics copied
    as the step returns (before a replay writes over them); the launch
    counters set to 0 before and checked after (``dim`` 2: all 0).  A
    ``FinetuneTrainer`` (``finetune``) steps on a batch and returns its
    metrics alone.  Returns (metrics, counts)."""
    import torch

    from pcrlv2_tpu_torch.ops import _build

    seen = []
    step = trainer.step

    def recorded(*args):
        out = step(*args)
        metrics = out if finetune else out[0]
        seen.append({k: v.clone() for k, v in metrics.items()})
        return out

    trainer.step = recorded
    try:
        _build.launches.clear()
        for epoch, epoch_batches in batches.items():
            trainer.train_epoch(epoch, epoch_batches)
        torch.cuda.synchronize()
        counts = (launched("pallas", len(seen), 0, what, finetune) if dim == 3
                  else no_launches(what))
    finally:
        del trainer.step
    return seen, counts


def state_leaves(trainer, metrics) -> dict:
    """Every piece of a run's state by name: parameters and BN statistics,
    momentum, step counter, generator states and each step's metrics."""
    names = [n for n, _ in trainer.state.model.named_parameters()]
    leaves = dict(trainer.state.model.state_dict())
    leaves.update({f"momentum of {n}": b for n, b in zip(names, trainer.state.optimizer.buffers)})
    leaves["step counter"] = trainer.state.step
    leaves.update({f"{k} generator state": g.get_state()
                   for k, g in trainer.generators().items()})
    for i, m in enumerate(metrics):
        leaves.update({f"step {i + 1} {k}": v for k, v in m.items()})
    return leaves


def differences(a: dict, b: dict) -> list:
    """(name, largest |difference|) of every leaf of ``a`` not bit-identical
    to ``b``'s, the largest first."""
    import torch

    out = []
    for k, x in a.items():
        y = b[k]
        if x.shape != y.shape or x.dtype != y.dtype:
            out.append((k, math.inf))
        elif not torch.equal(x, y):
            out.append((k, (x.double() - y.double()).abs().max().item()))
    return sorted(out, key=lambda kv: -kv[1])


def replay_loop(trainer, batches: list, steps: int) -> list:
    """``steps`` pipelined steps of ``trainer`` on device-resident batches
    under ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising
    call raises; the mode is reset after); returns the host's seconds per
    step (the call's return: what the host spends to enqueue or replay)."""
    import torch

    views = trainer.aug_fn(trainer.aug_gen, batches[0])
    torch.cuda.synchronize()
    host = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            _, views = trainer.step(views, batches[(i + 1) % len(batches)])
            host.append(time.perf_counter() - t0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return host


def graph_identity(amp: bool, tmp: str, **flags) -> dict:
    """Phase 10: from one initial state and seed, two epochs (a new LR in
    the second; each ending in the step-only program) on the eager loop and
    on the graphs; every parameter, BN statistic, momentum, the step
    counter, both generators' states and every step's metrics must be
    bit-identical, and the launch counts those of the steps.  Then each
    trainer's replay loop under the sync-debug mode, timing the host.
    ``flags``: ``graph_trainer``'s mixup and aug flags (phase 11)."""
    batches = graph_batches(seed=20)
    label = ("--amp" if amp else "f32") + "".join(f" {k}={v}" for k, v in flags.items())
    eager = graph_trainer(amp, os.path.join(tmp, "eager"), cuda_graph=False, **flags)
    graph = graph_trainer(amp, os.path.join(tmp, "graph"), cuda_graph=True, **flags)
    m_eager, counts_eager = run_epochs(eager, batches, f"eager loop {label}")
    m_graph, counts = run_epochs(graph, batches, f"graph replays {label}")
    diffs = differences(state_leaves(eager, m_eager), state_leaves(graph, m_graph))
    if diffs:
        raise AssertionError(
            f"{label}: the graph replays differ from the eager loop in {len(diffs)} "
            f"leaves; largest first: " + ", ".join(f"{k} ({d:.3e})" for k, d in diffs[:12]))
    host_eager = replay_loop(eager, batches[0], SYNC_STEPS)
    host_graph = replay_loop(graph, batches[0], SYNC_STEPS)
    for t in (eager, graph):
        t.logger.close()
    return {"steps": len(m_graph), "leaves": len(state_leaves(graph, m_graph)),
            "counts": counts, "eager_counts": counts_eager,
            "graphs": len(graph.captured.graphs),
            "capture_s": list(graph.captured.capture_s.values()),
            "losses": [float(m["loss"]) for m in m_graph],
            "host_s_eager": host_eager, "host_s_graph": host_graph}


class _Interrupted(Exception):
    pass


class _StopAt:
    """``inner``'s epochs, but the run stops at the start of epoch ``at``."""

    def __init__(self, inner, at: int):
        self.inner, self.at = inner, at

    def epoch(self, epoch: int):
        if epoch == self.at:
            raise _Interrupted
        return self.inner.epoch(epoch)


def graph_resume_check(tmp: str) -> dict:
    """Phase 10: epochs 0-2 on the graphs (``--amp``, 3 steps an epoch,
    the state saved every epoch) against epoch 0, a stop at the start of
    epoch 1, and a resume from the saved state on a model from another
    seed: parameters, BN statistics, momentum, step counter, generators and
    the logged losses equal bit for bit."""
    from pcrlv2_tpu_torch.cli.main import SyntheticLoader
    from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY
    from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.train.trainer import TrainConfig, run_training

    loader = SyntheticLoader(BATCH, 3, seed=11)

    def run(out, seed, loader, resume=None):
        cfg = TrainConfig(b=BATCH, epochs=2, log_every=1, save_every=1, seed=3, amp=True,
                          output=os.path.join(tmp, out), resume=resume)
        model = PCRLv23d(policy=DEFAULT_POLICY, seed=seed, device="cuda")
        return run_training(model, cfg, loader, make_luna_aug_fn(), "cuda")

    straight = run("a", 7, loader)
    try:
        run("b", 7, _StopAt(loader, 1))
        raise AssertionError("the interrupted run did not stop")
    except _Interrupted:
        pass
    resumed = run("b", 8, loader, resume=os.path.join(tmp, "b", "train_state"))
    diffs = differences(state_leaves(straight, []), state_leaves(resumed, []))
    losses = {d: [(r["epoch"], r["iter"], r["loss"]) for r in map(
        json.loads, open(os.path.join(tmp, d, "metrics.jsonl"))) if "iter" in r]
        for d in ("a", "b")}
    if diffs or losses["a"] != losses["b"] or int(resumed.state.step) != 9:
        raise AssertionError(f"resumed graph run vs unbroken: {diffs[:12]}, losses "
                             f"{losses}, step {int(resumed.state.step)}")
    return {"steps": int(resumed.state.step), "graphs": len(resumed.captured.graphs),
            "losses": [x[2] for x in losses["a"]]}


# Phase 11: the CLI flags of the rest of the 3D pretask surface
FLAGS = ["--use_painting", "--use_pixel_shuffle", "--mixup", "0.2"]
#: phase 10's identity check with every flag on (painting always)
FLAGS_IDENTITY = dict(mixup=0.2, use_painting=True, paint_rate=1.0, use_pixel_shuffle=True)
#: (run name, extra CLI flags, PCRL_AFFINE) of phase 11's CLI runs, under
#: ``pallas --amp`` beside phase 6's ``amp`` run
FLAG_RUNS = [("amp_flags", FLAGS, "shear"), ("amp_exact", [], "exact")]
#: (name, batch, bf16 policy) of phase 11's bench runs; the first through
#: ``bench.main()``, as ``python -m pcrlv2_tpu_torch.tools.bench`` runs it
BENCH_RUNS = [("b32_amp", 32, True), ("b32_f32", 32, False), ("b4_amp", 4, True),
              ("b4_f32", 4, False)]
BENCH_ENV = {"BENCH_WARMUP": "3", "BENCH_STEPS": "5", "BENCH_TRIALS": "3"}


def flagged_disk_run(tmp: str) -> dict:
    """Phase 11: the CLI's path with ``--data --b 4`` and ``FLAGS`` on a
    structured phantom tree (10 subsets × 2 UIDs × 3 pairs: 10 steps at
    b = 4), one epoch through the native reader; losses finite, launches
    exact."""
    import torch

    from pcrlv2_tpu_torch.cli.main import prepare
    from pcrlv2_tpu_torch.data.pipeline import write_structured_luna_tree
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.trainer import run_training

    tree, out = os.path.join(tmp, "tree"), os.path.join(tmp, "out")
    write_structured_luna_tree(tree, n_subsets=10, uids_per_subset=2, pairs_per_uid=3)
    argv = ["--data", tree, "--d", "3", "--b", str(BATCH), "--epochs", "0", "--log_every", "1",
            "--seed", "0", "--output", out] + FLAGS
    model, cfg, loaders, aug_fn, device = prepare(argv)
    reader = native_reader(loaders)
    steps = len(loaders["train"])
    _build.launches.clear()
    run_training(model, cfg, loaders["train"], aug_fn, device)
    torch.cuda.synchronize()
    counts = launched("pallas", steps, 0, "flagged disk CLI")
    _, rows = step_rows(os.path.join(out, "metrics.jsonl"))
    if len(rows) != steps or reader.batches != steps:
        raise AssertionError(f"{len(rows)} steps logged, {reader.batches} batches read, "
                             f"{steps} in the epoch")
    return {"counts": counts, "losses": [r["loss"] for r in rows],
            "step_s": step_times(rows), "dt_s": [r["DT"] for r in rows]}


def run_bench() -> dict:
    """Phase 11: the bench at ``BENCH_RUNS``, the trainers' memory freed
    first; ``bench.main()`` takes the GPU lock."""
    import gc

    import torch

    from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from pcrlv2_tpu_torch.data.pipeline import synthetic_luna_batch
    from pcrlv2_tpu_torch.tools import bench

    out = {}
    for name, batch, amp in BENCH_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if name == "b32_amp":
            with contextlib.ExitStack() as env:
                for k, v in {**BENCH_ENV, "BENCH_BATCH": str(batch)}.items():
                    env.enter_context(env_var(k, v))
                r = bench.main()
        else:
            r = bench.run(synthetic_luna_batch(batch), DEFAULT_POLICY if amp else PARITY_POLICY,
                          warmup=int(BENCH_ENV["BENCH_WARMUP"]),
                          steps=int(BENCH_ENV["BENCH_STEPS"]),
                          trials=int(BENCH_ENV["BENCH_TRIALS"]), device="cuda")
        out[name] = dict(r, wall_s=time.perf_counter() - t0)
    return out


# Phase 12: the 2D chest path.  run2d.sh trains at b = 64 on 4 GPUs: 16 a card
BATCH2D = 16
CANVAS2D = 512     # the canvas of phase 12's device-resident batches
CHEST_IMAGES = 32  # images of the disk path's tree: 2 steps an epoch at b = 16
#: device-kernel name fragment → group of phase 12's profiles (first match)
GROUPS2D = [(frag, "cuDNN convs (fwd, dgrad, wgrad)")
            for frag in ("fprop", "dgrad", "wgrad", "conv", "cudnn")] + [
    ("gemm", "cuBLAS GEMM (crops, resizes, blur, MLP)"), ("pool", "max pool"),
    ("elementwise", "elementwise"), ("reduce", "reductions (BN, GAP, losses)"),
    ("memcpy", "copies (the raw batch's, into the graph's buffers)")]
#: (name, BENCH_BATCH, bf16 policy) of phase 12's bench runs: the bench times
#: 2 × BENCH_BATCH images, as bench.py does; the first through bench.main()
BENCH2D_RUNS = [("b64_amp", 32, True), ("b32_amp", 16, True), ("b32_f32", 16, False)]


def no_launches(what: str) -> dict:
    """Every launch counter of #1-#10 must read 0 (the 2D path runs none)."""
    from pcrlv2_tpu_torch.ops import _build

    counts = {k: _build.launches[k] for k in list(KERNELS) + list(TOOL_KERNELS)}
    if any(counts.values()):
        raise AssertionError(f"{what}: launched {counts}, expected none")
    return counts


def model2d_reference_check():
    """Phase 12: ``PCRLv2``'s train-mode forward (segmentation output and the
    5 masks) at b = 4, 64² on the card against the same weights on the CPU:
    f32 (TF32 off) within 2e-4 of each output's largest entry (the port's
    f32 forward reads 3e-5 against a float64 JAX run at this size on the
    CPU; BatchNorm over 16 values a channel in the last stage amplifies the
    two sides' rounding); bf16 by phase 5's rule (1.5× the CPU's own bf16
    distance from its f32 forward, plus 2^-8 of the largest entry)."""
    import torch

    from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from pcrlv2_tpu_torch.models.unet2d import PCRLv2

    x = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(6))

    def forward(policy, device):
        model = PCRLv2(policy=policy, seed=5, device=device)
        with torch.no_grad():
            _, out, masks = model(x.to(device))
        return [v.float().cpu() for v in (out, *masks)]

    names = ("out",) + tuple(f"mask{i}" for i in range(5))
    f32_card, f32_cpu = forward(PARITY_POLICY, "cuda"), forward(PARITY_POLICY, "cpu")
    f32 = {n: (a - b).abs().max().item() / b.abs().max().item()
           for n, a, b in zip(names, f32_card, f32_cpu)}
    if not all(e <= 2e-4 for e in f32.values()):
        raise AssertionError(f"2D model on the card vs CPU, f32: {f32} (limit 2e-4)")
    bf16_card, bf16_cpu = forward(DEFAULT_POLICY, "cuda"), forward(DEFAULT_POLICY, "cpu")
    bf16 = {}
    for name, card, cpu, ref in zip(names, bf16_card, bf16_cpu, f32_cpu):
        scale = ref.abs().max().item()
        err = (card - ref).abs().max().item() / scale
        limit = 1.5 * (cpu - ref).abs().max().item() / scale + 2.0 ** -8
        bf16[name] = {"card_vs_cpu_f32": err, "limit": limit}
        if not err <= limit:
            raise AssertionError(f"bf16 2D model on the card, {name}: {err:.3e} of the "
                                 f"largest entry from the CPU's f32 forward, limit {limit:.3e}")
    return f32, bf16


def cli2d_argv(amp: bool, out_dir: str, steps: int):
    return (["--synthetic", "--d", "2", "--n", "chest", "--phase", "pretask", "--b",
             str(BATCH2D), "--epochs", "0", "--steps_per_epoch", str(steps), "--log_every", "1",
             "--seed", "0", "--output", out_dir] + (["--amp"] if amp else []))


def run_cli2d(amp: bool, out_dir: str, steps: int = STEPS) -> dict:
    """Phase 12: the port's CLI at ``--d 2`` in this process on the graphs,
    the launch counters set to 0 before and read after (all 0); losses
    finite; the encoder ``.pt`` loads strictly into ``ResNet18Encoder``."""
    import torch

    from pcrlv2_tpu_torch.cli.main import main as cli_main
    from pcrlv2_tpu_torch.models.resnet import ResNet18Encoder
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.checkpoint import import_resnet18_encoder

    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    trainer = cli_main(cli2d_argv(amp, out_dir, steps))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = no_launches(f"2D CLI{' --amp' if amp else ''}")
    _, rows = step_rows(os.path.join(out_dir, "metrics.jsonl"))
    if len(rows) != steps:
        raise AssertionError(f"expected {steps} logged rows, got {len(rows)}")
    import_resnet18_encoder(os.path.join(out_dir, "pcrlv2_chest_pretask_1.0_0.pt"),
                            ResNet18Encoder(device="cuda", seed=1))
    step_s = step_times(rows)
    return {"counts": counts, "wall_s": wall, "step_s": step_s,
            "step_s_median": statistics.median(step_s[WARMUP:]),
            "graphs": len(trainer.captured.graphs),
            "capture_s": list(trainer.captured.capture_s.values()),
            "dt_s": [r["DT"] for r in rows], "losses": [r["loss"] for r in rows],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def sync_free_step2d() -> dict:
    """Phase 12: one 2D ``train_step`` at b = 16 (224² and 6 × 96² views on
    the card), after a warm-up step, under ``set_sync_debug_mode("error")``."""
    import torch

    from pcrlv2_tpu_torch.models.unet2d import PCRLv2
    from pcrlv2_tpu_torch.train.step import LOSS_GUARD, TrainState, train_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    views = {k: torch.randn((BATCH2D, 224, 224, 3), generator=gen, device=dev)
             for k in ("x1", "x2", "gt")}
    views["locals"] = torch.randn((BATCH2D, 6, 96, 96, 3), generator=gen, device=dev)
    state = TrainState(PCRLv2(device="cuda", seed=7))
    levels = torch.arange(1 + 2 * 6, device=dev) % 5
    lr = torch.full((), 1e-3, device=dev)
    epoch = torch.zeros((), dtype=torch.int64, device=dev)
    train_step(state, views, levels, lr, epoch, loss_guard=LOSS_GUARD[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = train_step(state, views, levels, lr, epoch, loss_guard=LOSS_GUARD[2])
        host_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    loss, skipped, step = float(metrics["loss"]), float(metrics["skipped"]), int(state.step)
    if not (math.isfinite(loss) and skipped == 0.0 and step == 2):
        raise AssertionError(f"2D sync-free step: loss {loss}, skipped {skipped}, step {step}")
    return {"loss": loss, "host_s": host_s}


def graph_batches2d(seed: int) -> dict:
    """Phase 12's raw chest batches on the card: {epoch: [batch, ...]}."""
    import torch

    from pcrlv2_tpu_torch.data.pipeline import synthetic_chest_batch

    return {epoch: [{"image": torch.from_numpy(synthetic_chest_batch(
        BATCH2D, canvas=CANVAS2D, seed=seed + 10 * epoch + i)["image"]).cuda()}
        for i in range(n)] for epoch, n in enumerate(GRAPH_EPOCHS)}


def graph_trainer2d(amp: bool, out: str, cuda_graph: bool, seed: int = 7):
    """A 2D trainer from one seed (epochs 0-2 of the cosine LR)."""
    from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from pcrlv2_tpu_torch.data.augment2d import make_chest_aug_fn
    from pcrlv2_tpu_torch.models.unet2d import PCRLv2
    from pcrlv2_tpu_torch.train.trainer import TrainConfig, Trainer

    model = PCRLv2(policy=DEFAULT_POLICY if amp else PARITY_POLICY, seed=seed, device="cuda")
    cfg = TrainConfig(n="chest", b=BATCH2D, epochs=2, lr=1e-2, log_every=100, seed=3, amp=amp,
                      output=out)
    return Trainer(model, cfg, make_chest_aug_fn(), "cuda", cuda_graph=cuda_graph)


def graph_identity2d(amp: bool, tmp: str) -> dict:
    """Phase 12: phase 10's check on the 2D path: two epochs on the eager
    loop and on the graphs from one state and seed, every leaf bit for bit,
    no kernel of #1-#10 launched; then each trainer's replay loop under the
    sync-debug mode."""
    batches = graph_batches2d(seed=20)
    label = "2D " + ("--amp" if amp else "f32")
    eager = graph_trainer2d(amp, os.path.join(tmp, "eager"), cuda_graph=False)
    graph = graph_trainer2d(amp, os.path.join(tmp, "graph"), cuda_graph=True)
    m_eager, _ = run_epochs(eager, batches, f"eager loop {label}", dim=2)
    m_graph, counts = run_epochs(graph, batches, f"graph replays {label}", dim=2)
    diffs = differences(state_leaves(eager, m_eager), state_leaves(graph, m_graph))
    if diffs:
        raise AssertionError(
            f"{label}: the graph replays differ from the eager loop in {len(diffs)} "
            f"leaves; largest first: " + ", ".join(f"{k} ({d:.3e})" for k, d in diffs[:12]))
    host_eager = replay_loop(eager, batches[0], SYNC_STEPS)
    host_graph = replay_loop(graph, batches[0], SYNC_STEPS)
    no_launches(f"{label} sync-debug replays")
    for t in (eager, graph):
        t.logger.close()
    return {"steps": len(m_graph), "leaves": len(state_leaves(graph, m_graph)),
            "counts": counts, "graphs": len(graph.captured.graphs),
            "capture_s": list(graph.captured.capture_s.values()),
            "losses": [float(m["loss"]) for m in m_graph],
            "host_s_eager": host_eager, "host_s_graph": host_graph}


def chest_tree(root: str, n: int = CHEST_IMAGES, size: int = 1024) -> bool:
    """``n`` random 1024² grey PNGs under ``root/images`` and a
    ``chest_train.txt`` (name + 14 labels); returns whether Pillow wrote
    them.  Without Pillow the list names the images, none is written, and
    the caller writes their cache entries."""
    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        Image = None
    rng = np.random.RandomState(3)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    with open(os.path.join(root, "chest_train.txt"), "w") as f:
        for i in range(n):
            name = f"images/{i:05d}.png"
            if Image is not None:
                Image.fromarray(rng.randint(0, 256, (size, size), dtype=np.uint8), "L").save(
                    os.path.join(root, name), compress_level=1)
            f.write(name + " " + " ".join(str(v) for v in rng.randint(0, 2, 14)) + "\n")
    return Image is not None


def write_chest_cache(root: str, cache: str, size: int = 1024) -> int:
    """The entries ``CachedChestReader(cache, size)`` would write for the
    tree's images, written here (random grey uint8 (size, size, 1))."""
    import numpy as np

    from pcrlv2_tpu_torch.data.manifests import get_chest_list
    from pcrlv2_tpu_torch.data.pipeline import CachedChestReader

    names, _ = get_chest_list(os.path.join(root, "chest_train.txt"), root)
    reader = CachedChestReader(cache, size)
    rng = np.random.RandomState(4)
    for name in names:
        np.save(reader.cache_path(name), rng.randint(0, 256, (size, size, 1), dtype=np.uint8))
    return len(names)


def run_disk2d(tmp: str) -> dict:
    """Phase 12: the CLI's 2D path on a chest tree through the decode cache:
    epochs 0-1 with eval and saves, then ``--resume`` at epoch 2, which must
    read every image from the cache and decode none."""
    import torch

    from pcrlv2_tpu_torch.cli.main import prepare
    from pcrlv2_tpu_torch.models.resnet import ResNet18Encoder
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.checkpoint import import_resnet18_encoder
    from pcrlv2_tpu_torch.train.trainer import run_training

    tree, out = os.path.join(tmp, "tree"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    pil = chest_tree(tree)
    argv = ["--data", tree, "--d", "2", "--n", "chest", "--b", str(BATCH2D),
            "--train_list", os.path.join(tree, "chest_train.txt"), "--eval_every", "1",
            "--save_every", "1", "--log_every", "1", "--seed", "0", "--output", out]
    if not pil:
        print("[12] Pillow is not installed on this machine: the disk path reads cache "
              "entries written here, and PNG decoding is held by the CPU tests only",
              flush=True)
        write_chest_cache(tree, os.path.join(out, "chest_cache"))
        argv += ["--chest_canvas", "1024"]
    write_s = time.perf_counter() - t0
    steps = CHEST_IMAGES // BATCH2D
    reads, runs = [], [(argv + ["--epochs", "1"], 2),
                       (argv + ["--epochs", "2", "--resume", os.path.join(out, "train_state")], 1)]
    for run_argv, epochs in runs:
        model, cfg, loaders, aug_fn, device = prepare(run_argv)
        reader = loaders["train"].read_fn
        _build.launches.clear()
        run_training(model, cfg, loaders["train"], aug_fn, device, eval_loader=loaders["eval"])
        torch.cuda.synchronize()
        no_launches("2D disk CLI")
        reads.append({"decoded": reader.decoded, "cached": reader.cached})
    # every read: each epoch's train pass and eval pass over every image
    if pil and reads[0] != {"decoded": CHEST_IMAGES, "cached": 3 * CHEST_IMAGES}:
        raise AssertionError(f"first run's reads {reads[0]}")
    if reads[1] != {"decoded": 0, "cached": 2 * CHEST_IMAGES}:
        raise AssertionError(f"the resumed run decoded or missed images: {reads[1]}")
    rows = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl"))]
    per_epoch = {e: step_rows(os.path.join(out, "metrics.jsonl"), e)[1] for e in (0, 1, 2)}
    if [len(v) for v in per_epoch.values()] != [steps] * 3:
        raise AssertionError(f"steps per epoch {[len(v) for v in per_epoch.values()]}")
    evals = [r for r in rows if "eval" in r]
    if [r["epoch"] for r in evals] != [0, 1, 2] or not all(
            math.isfinite(v) for r in evals for v in r["eval"].values()):
        raise AssertionError(f"eval rows {evals}")
    state = torch.load(os.path.join(out, "train_state", "state.pt"), weights_only=True)
    if (state["epoch"], state["step"]) != (2, 3 * steps):
        raise AssertionError(f"train state at epoch {state['epoch']} step {state['step']}")
    import_resnet18_encoder(os.path.join(out, "pcrlv2_chest_pretask_1.0_0.pt"),
                            ResNet18Encoder(device="cuda", seed=1))
    return {"pillow": pil, "tree_write_s": write_s, "reads": reads,
            "step_s": [step_times(per_epoch[e]) for e in (0, 1, 2)],
            "dt_s": [[r["DT"] for r in per_epoch[e]] for e in (0, 1, 2)],
            "evals": [r["eval"] for r in evals]}


def run_bench2d() -> dict:
    """Phase 12: the bench at ``BENCH_DIM=2`` for ``BENCH2D_RUNS``."""
    import gc

    import torch

    from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from pcrlv2_tpu_torch.data.pipeline import synthetic_chest_batch
    from pcrlv2_tpu_torch.tools import bench

    out = {}
    for name, size, amp in BENCH2D_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if name == "b64_amp":
            with contextlib.ExitStack() as env:
                for k, v in {**BENCH_ENV, "BENCH_BATCH": str(size), "BENCH_DIM": "2"}.items():
                    env.enter_context(env_var(k, v))
                r = bench.main()
        else:
            r = bench.run(synthetic_chest_batch(2 * size),
                          DEFAULT_POLICY if amp else PARITY_POLICY,
                          warmup=int(BENCH_ENV["BENCH_WARMUP"]),
                          steps=int(BENCH_ENV["BENCH_STEPS"]),
                          trials=int(BENCH_ENV["BENCH_TRIALS"]), device="cuda")
        no_launches(f"2D bench {name}")
        out[name] = dict(r, wall_s=time.perf_counter() - t0)
    return out


# Phase 13: finetuning.  The README's 3D recipe finetunes at --b 8
# (README.md:38-43); the 2D classifier at run2d.sh's 16 images a card
BATCH_FT = {3: 8, 2: 16}
FT_EVAL_BATCHES = 2  # eval batches of each finetune CLI run (--eval_batches)
# the 3D finetune path's launch shapes: one model call a step, at
# local=True, on the b = 8 volumes (phases 3-4 cover b = 4 and the locals)
FT_CALLS = {"finetune": (BATCH_FT[3], CALLS["global"][1])}
FT_KERNELS = ("conv3d_fwd", "conv3d_dw", "head_fwd")  # the kernels it runs (pallas)


def finetune_kernel_check() -> dict:
    """Phase 13: #1 (forward and dx), #2 and #3 at each of the finetune
    path's launch shapes (``FT_CALLS``), in f32 and bf16 (``--amp``),
    against their plain versions at phases 3-4's tolerances (``TOL``).  Not
    timed, and not in the kernels line's sums, which stay one pretask
    step's."""
    import torch

    checked, worst, failures = 0, {}, []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for case_fn in (conv_cases, head_cases):
            for kernel, label, kfn, pfn, _, _, _, kinds in case_fn(dtype, FT_CALLS):
                if kernel not in FT_KERNELS:
                    continue
                got, ref = kfn(), pfn()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                errs = [rel_err(a, b)[0] for a, b in zip(got, ref)]
                tols = [TOL[(dname, kind)] for kind in kinds]
                worst[dname] = max([worst.get(dname, 0.0)]
                                   + [e / t for e, t in zip(errs, tols)])
                checked += 1
                if any(e > t for e, t in zip(errs, tols)):
                    failures.append(f"{dname} {label}: rel err {errs} > {tols}")
                del got, ref
    if failures:
        raise AssertionError("finetune shapes:\n  " + "\n  ".join(failures))
    return {"checked": checked, "worst_share_of_tol": worst}


def finetune_argv(dim: int, amp: bool, out: str, steps: int, extra=()):
    return (["--synthetic", "--d", str(dim), "--n", "luna" if dim == 3 else "chest",
             "--phase", "finetune", "--b", str(BATCH_FT[dim]), "--epochs", "0",
             "--steps_per_epoch", str(steps), "--seed", "0", "--output", out]
            + (["--amp"] if amp else []) + list(extra))


def finetune_launches(dim: int, steps: int, eval_batches: int, what: str) -> dict:
    """3D: the counters against ``expected_launches``' finetune form under
    ``pallas``; 2D: every counter at 0."""
    return (launched("pallas", steps, eval_batches, what, finetune=True) if dim == 3
            else no_launches(what))


def schema_check(state: dict, n_class: int) -> None:
    """``state`` has every key and shape of torchvision's ResNet-18
    (``tests/fixtures/torchvision_resnet18_schema.txt``), ``fc`` n_class × 512."""
    want = {}
    for line in open(os.path.join(ROOT, "tests", "fixtures", "torchvision_resnet18_schema.txt")):
        if line.strip() and not line.startswith("#"):
            key, rest = line.split(" ", 1)
            want[key] = tuple(int(d) for d in rest.rsplit(" ", 1)[0].strip("()").split(",")
                              if d.strip())
    want.update({"fc.weight": (n_class, 512), "fc.bias": (n_class,)})
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got != want:
        raise AssertionError(f"the 2D finetune .pt is not torchvision's schema: "
                             f"{sorted(set(got) ^ set(want))[:6]} differ")


def run_finetune_cli(dim: int, amp: bool, out: str, steps: int = STEPS) -> dict:
    """Phase 13: the port's CLI at ``--phase finetune`` (synthetic, ``steps``
    steps, ``--eval_every 1 --eval_batches 2``) on the graphs, the launch
    counters set to 0 just before and read just after; every loss and
    metric finite, train and eval (2D: ``eval_auc`` too); the ``.pt``: 3D
    loading strictly into ``PCRLv23d``, 2D torchvision's schema with an
    ``fc`` moved from its initial weights.  Then the step time: the same
    path (``prepare_finetune`` → ``FinetuneTrainer``) over one epoch, the
    device synchronised after each step (each iteration's own time, as
    ``BT`` at ``--log_every 1``), and peak memory."""
    import torch

    from pcrlv2_tpu_torch.cli.main import main as cli_main
    from pcrlv2_tpu_torch.cli.main import prepare_finetune
    from pcrlv2_tpu_torch.data.pipeline import device_prefetch
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.checkpoint import import_pcrlv23d, load_reference_checkpoint
    from pcrlv2_tpu_torch.train.finetune import ChestClassifier, FinetuneTrainer

    label = f"finetune CLI --d {dim}{' --amp' if amp else ''}"
    extra = ["--eval_every", "1", "--eval_batches", str(FT_EVAL_BATCHES)]
    _build.launches.clear()
    t0 = time.perf_counter()
    trainer = cli_main(finetune_argv(dim, amp, out, steps, extra))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = finetune_launches(dim, steps, FT_EVAL_BATCHES, label)
    rows = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl"))]
    train_rows = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "eval_loss" in r]
    if len(train_rows) != 1 or len(evals) != 1 or not all(
            math.isfinite(v) for r in train_rows + evals for k, v in r.items()
            if k in ("loss", "metric") or k.startswith("eval_")):
        raise AssertionError(f"{label}: rows {train_rows}, eval {evals}")
    if dim == 2 and "eval_auc" not in evals[0]:
        raise AssertionError(f"{label}: no eval_auc in {evals[0]}")
    path = os.path.join(out, f"pcrlv2_{'luna' if dim == 3 else 'chest'}_finetune_1.0_0.pt")
    if dim == 3:
        import_pcrlv23d(path, PCRLv23d(device="cuda", seed=1))
    else:
        state = load_reference_checkpoint(path)["state_dict"]
        schema_check(state, 14)
        fresh = ChestClassifier(seed=0, device="cuda")
        if torch.equal(state["fc.weight"], fresh.fc.weight.detach().cpu()):
            raise AssertionError(f"{label}: fc did not move")
    graphs, capture_s = len(trainer.captured.graphs), list(trainer.captured.capture_s.values())
    del trainer  # its model, optimizer and graph pool: not counted in the timed run's peak
    gc.collect()
    torch.cuda.empty_cache()

    cfg, loaders, device, options = prepare_finetune(
        finetune_argv(dim, amp, os.path.join(out, "timed"), steps))
    allocated_before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    timer = FinetuneTrainer(cfg, device=device, **options)
    step_s = []

    def timed(batches):
        t = time.perf_counter()
        for batch in batches:
            yield batch
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_s.append(now - t)
            t = now

    try:
        with contextlib.closing(device_prefetch(loaders["train"].epoch(0), device)) as batches:
            timer.train_epoch(0, timed(batches))
    finally:
        timer.logger.close()
    return {"counts": counts, "wall_s": wall, "graphs": graphs, "capture_s": capture_s,
            "loss": train_rows[0]["loss"], "metric": train_rows[0]["metric"], "eval": evals[0],
            "step_s": step_s, "step_s_median": statistics.median(step_s[WARMUP:]),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "allocated_gib_before": allocated_before}


def finetune_disk_run(tmp: str) -> dict:
    """Phase 13: a pretask ``.pt`` (the pretask CLI, one step), then 3D
    finetuning from it (``--weight``) on a structured phantom tree with its
    masks beside the crops (``--mask_dir`` = the tree; 10 subsets × 4 UIDs ×
    2 pairs, ``--ratio 0.5``: 16 train crops, 2 steps an epoch at b = 8),
    ``--epochs 1 --eval_every 1 --eval_batches 2 --save_every 1``, on the
    graphs: the loader's samples carry the mask files' crop-0 masks, the
    launches are exact, every eval loss and dice finite, and each epoch's
    ``.pt`` loads strictly."""
    import numpy as np
    import torch

    from pcrlv2_tpu_torch.cli.main import main as cli_main
    from pcrlv2_tpu_torch.cli.main import prepare_finetune
    from pcrlv2_tpu_torch.data.pipeline import mask_path_for, write_structured_luna_tree
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.checkpoint import import_pcrlv23d
    from pcrlv2_tpu_torch.train.finetune import run_finetune

    pretask = os.path.join(tmp, "pretask")
    cli_main(cli_argv(False, pretask, 1))
    weight = os.path.join(pretask, "pcrlv2_luna_pretask_1.0_0.pt")
    tree, out = os.path.join(tmp, "tree"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    uids = write_structured_luna_tree(tree, n_subsets=10, uids_per_subset=4, pairs_per_uid=2)
    write_s = time.perf_counter() - t0
    uid_list = os.path.join(tmp, "luna_train.txt")
    with open(uid_list, "w") as fh:
        fh.write("".join(u + "\n" for u in uids))
    cfg, loaders, device, options = prepare_finetune(
        ["--data", tree, "--d", "3", "--n", "luna", "--phase", "finetune", "--train_list",
         uid_list, "--ratio", "0.5", "--mask_dir", tree, "--weight", weight, "--b",
         str(BATCH_FT[3]), "--epochs", "1", "--eval_every", "1", "--eval_batches",
         str(FT_EVAL_BATCHES), "--save_every", "1", "--seed", "0", "--output", out])
    train = loaders["train"]
    sample = train.read_fn(train.paths[0])
    if not np.array_equal(sample["mask"][..., 0],
                          np.load(mask_path_for(train.paths[0], tree, tree))[0]):
        raise AssertionError("the finetune loader's mask is not the mask file's crop 0")
    steps = len(train)
    _build.launches.clear()
    run_finetune(cfg, train, eval_loader=loaders["eval"], device=device, **options)
    torch.cuda.synchronize()
    counts = launched("pallas", 2 * steps, 2 * FT_EVAL_BATCHES, "3D finetune disk CLI",
                      finetune=True)
    rows = [json.loads(s) for s in open(os.path.join(out, "metrics.jsonl"))]
    evals = [r for r in rows if "eval_loss" in r]
    if [r["epoch"] for r in evals] != [0, 1] or not all(
            math.isfinite(r[k]) for r in evals for k in ("eval_loss", "eval_dice")):
        raise AssertionError(f"finetune eval rows {evals}")
    for epoch in (0, 1):
        import_pcrlv23d(os.path.join(out, f"pcrlv2_luna_finetune_0.5_{epoch}.pt"),
                        PCRLv23d(device="cuda", seed=1))
    return {"tree_write_s": write_s, "steps_per_epoch": steps, "counts": counts,
            "losses": [r["loss"] for r in rows if "loss" in r], "evals": evals}


def finetune_trainer(dim: int, amp: bool, out: str, cuda_graph: bool):
    """A finetune trainer from one seed (epochs 0-2 of the cosine LR); the
    2D classifier keeps its dropout."""
    from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from pcrlv2_tpu_torch.train.finetune import FinetuneTrainer
    from pcrlv2_tpu_torch.train.trainer import TrainConfig

    cfg = TrainConfig(n="luna" if dim == 3 else "chest", phase="finetune", b=BATCH_FT[dim],
                      epochs=2, lr=1e-2, seed=3, amp=amp, output=out)
    return FinetuneTrainer(cfg, dim=dim, n_class=14 if dim == 2 else 1,
                           policy=DEFAULT_POLICY if amp else PARITY_POLICY, device="cuda",
                           cuda_graph=cuda_graph)


def finetune_batches(dim: int, seed: int) -> dict:
    """Raw finetune batches on the card, {epoch: [batch, ...]}: 3D LUNA crop
    pairs; 2D uint8 grey 224² images (the chest reader's form) and 14
    labels."""
    import numpy as np
    import torch

    from pcrlv2_tpu_torch.data.pipeline import synthetic_luna_batch

    def batch(s):
        if dim == 3:
            raw = {"pair": synthetic_luna_batch(BATCH_FT[3], seed=s)["pair"]}
        else:
            rng = np.random.RandomState(s)
            raw = {"image": rng.randint(0, 256, (BATCH_FT[2], 224, 224, 1)).astype(np.uint8),
                   "label": rng.randint(0, 2, (BATCH_FT[2], 14)).astype(np.float32)}
        return {k: torch.from_numpy(v).cuda() for k, v in raw.items()}

    return {epoch: [batch(seed + 10 * epoch + i) for i in range(n)]
            for epoch, n in enumerate(GRAPH_EPOCHS)}


def finetune_identity(dim: int, amp: bool, tmp: str) -> dict:
    """Phase 13: phase 10's check on the finetune step: two epochs (a new LR
    in the second) on the eager loop and on the graphs from one state and
    seed; every parameter, BN statistic, momentum, the step counter, the
    dropout generator's state (2D) and every step's metrics bit-identical,
    and the launches exact under replay (2D: none)."""
    batches = finetune_batches(dim, seed=20)
    label = f"finetune {dim}D " + ("--amp" if amp else "f32")
    eager = finetune_trainer(dim, amp, os.path.join(tmp, "eager"), cuda_graph=False)
    graph = finetune_trainer(dim, amp, os.path.join(tmp, "graph"), cuda_graph=True)
    m_eager, _ = run_epochs(eager, batches, f"eager loop {label}", dim, finetune=True)
    m_graph, counts = run_epochs(graph, batches, f"graph replays {label}", dim, finetune=True)
    diffs = differences(state_leaves(eager, m_eager), state_leaves(graph, m_graph))
    if diffs:
        raise AssertionError(
            f"{label}: the graph replays differ from the eager loop in {len(diffs)} "
            f"leaves; largest first: " + ", ".join(f"{k} ({d:.3e})" for k, d in diffs[:12]))
    for t in (eager, graph):
        t.logger.close()
    return {"steps": len(m_graph), "leaves": len(state_leaves(graph, m_graph)),
            "counts": counts, "graphs": len(graph.captured.graphs),
            "capture_s": list(graph.captured.capture_s.values()),
            "losses": [float(m["loss"]) for m in m_graph]}


def sync_free_finetune_step(dim: int) -> dict:
    """Phase 13: one finetune step at full width on device-resident data
    (3D: the pseudo-mask computed inside; 2D: uint8 grey images, dropout on
    a device generator), after a warm-up step, under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch

    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.train.finetune import (ChestClassifier, finetune_step_2d,
                                                 finetune_step_3d, images_and_labels,
                                                 volumes_and_masks)
    from pcrlv2_tpu_torch.train.step import TrainState

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = finetune_batches(dim, seed=30)[0][0]
    lr = torch.full((), 1e-3, device=dev)
    if dim == 3:
        state = TrainState(PCRLv23d(device="cuda", seed=7))

        def step():
            return finetune_step_3d(state, *volumes_and_masks(batch), lr)
    else:
        state = TrainState(ChestClassifier(seed=7, device="cuda"))

        def step():
            return finetune_step_2d(state, *images_and_labels(batch), lr, gen)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step()
        host_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    loss, steps = float(metrics["loss"]), int(state.step)
    if not (math.isfinite(loss) and steps == 2):
        raise AssertionError(f"sync-free finetune step --d {dim}: loss {loss}, step {steps}")
    return {"loss": loss, "host_s": host_s}


def finetune_phase(profiles: dict) -> dict:
    """Phase 13 (the module docstring's item 13); the profiles go into
    ``profiles``."""
    print("[13] finetuning (--phase finetune)", flush=True)
    t13 = time.perf_counter()
    ft = {"kernel_check": finetune_kernel_check()}
    print(f"[13] #1 (fwd, dx), #2, #3 at the finetune shapes (b = {BATCH_FT[3]}): "
          f"{ft['kernel_check']['checked']} launches against their plain versions, largest "
          f"error { {k: round(v, 3) for k, v in ft['kernel_check']['worst_share_of_tol'].items()} }"
          f" of its tolerance", flush=True)
    for dim in (3, 2):
        for amp in (False, True):
            name = f"{dim}d_{'amp' if amp else 'f32'}"
            with tempfile.TemporaryDirectory() as tmp, env_var("PCRL_CONV3D", "pallas"):
                ft[name] = r = run_finetune_cli(dim, amp, tmp)
                profiles["finetune_" + name] = p = profile_cli(
                    finetune_argv(dim, amp, os.path.join(tmp, "prof"), PROFILE_STEPS),
                    r["step_s_median"], groups=GROUPS if dim == 3 else GROUPS2D)
            print(f"[13] CLI --d {dim} --phase finetune --b {BATCH_FT[dim]}"
                  f"{' --amp' if amp else ''}: launches "
                  f"{ {k: v for k, v in r['counts'].items() if v} } for {STEPS} steps and "
                  f"{FT_EVAL_BATCHES} eval batches, step s "
                  f"{[round(x, 4) for x in r['step_s']]} (median after {WARMUP}: "
                  f"{r['step_s_median']:.4f}), captures "
                  f"{[round(c, 3) for c in r['capture_s']]} s, loss {r['loss']:.5f}, "
                  f"metric {r['metric']:.5f}, eval {r['eval']}, peak "
                  f"{r['peak_mem_gib']:.2f} GiB ({r['allocated_gib_before']:.2f} GiB held "
                  f"before the timed run)", flush=True)
            print_profile("finetune_" + name, p)
    with tempfile.TemporaryDirectory() as tmp, env_var("PCRL_CONV3D", "pallas"):
        ft["disk"] = d = finetune_disk_run(tmp)
    print(f"[13] 3D finetune from a pretask .pt (--weight) on a phantom tree with "
          f"--mask_dir, 2 epochs of {d['steps_per_epoch']} steps: masks read from the "
          f"tree, launches {d['counts']}, losses {[round(x, 5) for x in d['losses']]}, "
          f"eval {[{k: round(v, 5) for k, v in e.items() if k != 'ts'} for e in d['evals']]}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp, env_var("PCRL_CONV3D", "pallas"):
        for dim in (3, 2):
            for amp in (False, True):
                name = f"identity_{dim}d_{'amp' if amp else 'f32'}"
                ft[name] = g = finetune_identity(dim, amp, os.path.join(tmp, name))
                print(f"[13] finetune {dim}D {'--amp' if amp else 'f32'}: {g['steps']} "
                      f"steps over two epochs, {g['graphs']} graphs captured in "
                      f"{[round(c, 3) for c in g['capture_s']]} s: all {g['leaves']} "
                      f"leaves bit-identical to the eager loop; launches "
                      f"{ {k: v for k, v in g['counts'].items() if v} }", flush=True)
        for dim in (3, 2):
            ft[f"sync_free_{dim}d"] = sf = sync_free_finetune_step(dim)
            print(f"[13] one {dim}D finetune step under set_sync_debug_mode('error'): no "
                  f"sync; loss {sf['loss']:.5f}, host {sf['host_s']:.4f} s to enqueue",
                  flush=True)
    ft["phase_s"] = time.perf_counter() - t13
    print(f"[13] phase 13 took {ft['phase_s']:.1f} s", flush=True)
    return ft


def kernel_entry(name: str, src: str, replaces: str, launches: int, s: dict) -> dict:
    """One kernel of the kernels line, from its summary ``s``.  ``bf16_ms``,
    ``bf16_bound_ms`` and ``bf16_library_ms`` are its bf16 sums; the tools'
    kernels are timed in bf16 at B = 32 (their f32 sums are in
    ``chip_smoke_kernels.json``), so theirs repeat ``ms``, ``bound_ms`` and
    ``library_ms``.  #10 adds the device times and its launch path's floor
    (``probe_times``)."""
    pre = "bf16_" if "bf16_ms" in s else ""
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes",
            "library_ms": s["library_ms"], "bf16_ms": s[pre + "ms"],
            "bf16_bound_ms": s[pre + "bound_ms"], "bf16_library_ms": s[pre + "library_ms"],
            **{k: s[k] for k in ("device_ms", "floor_ms", "floor_device_ms",
                                 "library_device_ms") if k in s}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from pcrlv2_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    # the trainers and the bench take the GPU lock: keep it on this run's
    # own ground, where no other run meets it
    lock_dir = tempfile.mkdtemp(prefix="chip_smoke_lock_")
    os.environ["PCRL_CHIP_LOCK"] = os.path.join(lock_dir, "gpu.lock")
    try:
        from pcrlv2_tpu_torch.tools.bench import device_label
        card = device_label(torch.device("cuda", 0))
        if card.endswith("power limit not read"):
            raise RuntimeError(f"nvidia-smi could not be read ({card})")
        print(f"[1] card: {card}", flush=True)

        t0 = time.perf_counter()
        report = _build.build(verbose=True)
        print(f"[2] built {sorted(report)} in {time.perf_counter() - t0:.1f} s "
              f"({', '.join(f'{k} {s:.1f} s' for k, (s, _) in report.items())})")
        with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as fh:
            for name, (_, log) in report.items():
                fh.write(f"== {name}\n{log}\n")
        for name, (_, log) in report.items():
            for line in log.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"    {name}: {line.strip()}")
        spilled = spills(report)
        print(f"[2] kernels that spill: {spilled if spilled else 'none'}", flush=True)

        print("[3,4] kernels vs plain versions at the main-path shapes", flush=True)
        rows = []
        summary, failures = check_and_time(rows)
        if failures:
            raise AssertionError("kernel disagrees with its plain version:\n  "
                                 + "\n  ".join(failures))

        err, bf16_model = model_reference_check()
        print(f"[5] model forward on the card vs CPU: f32 max abs err {err:.2e}; bf16 "
              f"(of the largest entry, from the CPU's f32 forward, vs limit): " + ", ".join(
                  f"{k} {v['card_vs_cpu_f32']:.2e} vs {v['limit']:.2e}"
                  for k, v in bf16_model.items()), flush=True)
        odd_rows = check_odd_shapes()
        print(f"[5] shapes off the main path: {len(odd_rows)} launches within tolerance, "
              f"largest rel err f32 {max(r['rel_err'] for r in odd_rows if r['dtype'] == 'float32'):.2e}"
              f", bf16 {max(r['rel_err'] for r in odd_rows if r['dtype'] == 'bfloat16'):.2e}",
              flush=True)
        in_ch = in_channels_check()
        print(f"[5] PCRLv23d(in_channels=2): card vs CPU f32 forward "
              f"{in_ch['f32_forward_max_abs_err']:.2e}; one train step under each selector, "
              f"losses {({k: round(v['loss'], 5) for k, v in in_ch['steps'].items()})}",
              flush=True)

        runs = {}
        for name, selector, amp in RUNS:
            with tempfile.TemporaryDirectory() as tmp:
                runs[name] = r = run_cli(selector, amp, tmp)
            print(f"[6] CLI PCRL_CONV3D={selector}{' --amp' if amp else ''}: launches "
                  f"{ {k: v / STEPS for k, v in r['counts'].items()} } per step, step s "
                  f"{[round(s, 4) for s in r['step_s']]} (median after {WARMUP}: "
                  f"{r['step_s_median']:.4f}), DT {[round(s, 4) for s in r['dt_s']]}, "
                  f"losses {[round(x, 5) for x in r['losses']]}, peak "
                  f"{r['peak_mem_gib']:.2f} GiB", flush=True)

        for name, selector, amp in EAGER_RUNS:
            with tempfile.TemporaryDirectory() as tmp:
                runs["eager_" + name] = r = run_cli(selector, amp, tmp, cuda_graph=False)
            g = runs[name]
            print(f"[6] CLI PCRL_CONV3D={selector}{' --amp' if amp else ''} on the eager "
                  f"loop: step s {[round(s, 4) for s in r['step_s']]} (median after "
                  f"{WARMUP}: {r['step_s_median']:.4f}; graphs {g['step_s_median']:.4f}, "
                  f"their captures {[round(c, 4) for c in g['capture_s']]} s), peak "
                  f"{r['peak_mem_gib']:.2f} GiB (graphs {g['peak_mem_gib']:.2f})", flush=True)

        for name, selector, amp in EAGER_RUNS:
            for graphs in (True, False):
                key = ("" if graphs else "eager_") + name + "_log10"
                with tempfile.TemporaryDirectory() as tmp:
                    runs[key] = r = run_cli(selector, amp, tmp, LONG_STEPS, LOG_EVERY,
                                            cuda_graph=graphs)
                print(f"[6] CLI PCRL_CONV3D={selector}{' --amp' if amp else ''} --log_every "
                      f"{LOG_EVERY}, {LONG_STEPS} steps, {'graphs' if graphs else 'eager'}: "
                      f"window step s {[round(s, 4) for s in r['step_s']]} (mean of windows "
                      f"2-3: {r['step_s_median']:.4f}), losses "
                      f"{[round(x, 5) for x in r['losses']]}", flush=True)
        sync = sync_free_step()
        print(f"[6] one train step under set_sync_debug_mode('error'): no sync; loss "
              f"{sync['loss']:.5f}, host {sync['host_s']:.4f} s to enqueue", flush=True)

        profiles = {}
        for name, selector, amp in RUNS + [("eager_" + n, sel, a) for n, sel, a in EAGER_RUNS]:
            with tempfile.TemporaryDirectory() as tmp, env_var("PCRL_CONV3D", selector):
                profiles[name] = p = profile_cli(cli_argv(amp, tmp, PROFILE_STEPS),
                                                 runs[name]["step_s_median"],
                                                 cuda_graph=not name.startswith("eager_"))
            print_profile(name, p)
            slab = p["slab_kernels"]
            if amp and selector != "pallas" and not (slab and all("_mma" in k for k in slab)):
                raise AssertionError(f"{name}: #5/#6 ran {p['slab_kernels']}, not on tensor cores")

        with tempfile.TemporaryDirectory() as tmp:
            runs["disk"] = d = run_disk(tmp)
            with env_var("PCRL_CONV3D", "packed"):
                profiles["disk"] = p = profile_cli(
                    disk_argv(d.pop("tree"), os.path.join(tmp, "prof")) + ["--epochs", "0"],
                    d["step_s_median"])
        print(f"[8] disk CLI under packed: native reader, one epoch ("
              f"{d['reader_batches_compared']} batches) bit-equal to the NumPy reader's, "
              f"{d['reader_batches_served']} train batches served; trained, evaluated and "
              f"saved epochs 0-1, resumed at epoch 2; launches {d['counts']}; epoch-0 step s "
              f"{[round(s, 4) for s in d['step_s']]} (median after {WARMUP}: "
              f"{d['step_s_median']:.4f}), DT {[round(s, 4) for s in d['dt_s']]} "
              f"(epoch mean {d['epoch0_data_time_s']:.4f}); eval losses "
              f"{[round(e['loss'], 5) for e in d['evals']]}", flush=True)
        print_profile("disk", p)

        print("[9] the kernel prototype tools at the JAX tools' shapes", flush=True)
        t9 = time.perf_counter()
        tools = run_tools()
        print(f"[9] tool runs: launches {tools['counts']} in {tools['wall_s']:.1f} s",
              flush=True)
        tool_rows = []
        tool_summary, failures = check_and_time_tools(tool_rows)
        if failures:
            raise AssertionError("tool kernel disagrees with its plain version:\n  "
                                 + "\n  ".join(failures))
        for name, s in tool_summary.items():
            print(f"[9] {name}: {s['ms']:.3f} ms over {s['shapes']} shapes (plain "
                  f"{s['plain_ms']:.3f}, PyTorch call {s['library_ms']:.3f}, bound "
                  f"{s['bound_ms']:.4f}, the formulation's FLOPs {s['product_ops_ms']:.4f}), "
                  f"max abs err {s['max_abs_err']:.3e}; f32 at B = "
                  f"{TOOL_F32_BATCH}: {s['f32_ms']:.3f} ms over {s['f32_shapes']} shapes (plain "
                  f"{s['f32_plain_ms']:.3f}, PyTorch call {s['f32_library_ms']:.3f}, bound "
                  f"{s['f32_bound_ms']:.4f}, the formulation's FLOPs "
                  f"{s['f32_product_ops_ms']:.4f})", flush=True)
        tool_odd_rows = check_odd_shapes((tool_odd_cases,))
        print(f"[9] tool shapes off the sweep: {len(tool_odd_rows)} launches within tolerance, "
              f"largest rel err f32 "
              f"{max(r['rel_err'] for r in tool_odd_rows if r['dtype'] == 'float32'):.2e}, bf16 "
              f"{max(r['rel_err'] for r in tool_odd_rows if r['dtype'] == 'bfloat16'):.2e}",
              flush=True)
        probes = probe_times()
        sums = {k: sum(r[k] for r in probes) for k in probes[0] if k != "probe"}
        print(f"[9] #10's launch path, summed over the {len(probes)} probes (ms per call, "
              f"host-inclusive / device): run {sums['kernel_ms']:.4f} / "
              f"{sums['kernel_device_ms']:.4f}, PyTorch expressions {sums['expr_ms']:.4f} / "
              f"{sums['expr_device_ms']:.4f}, floor {sums['floor_ms']:.4f} / "
              f"{sums['floor_device_ms']:.4f}", flush=True)
        for r in probes:
            print(f"    {r['probe']}: run {r['kernel_ms']:.4f} / {r['kernel_device_ms']:.4f}, "
                  f"expression {r['expr_ms']:.4f} / {r['expr_device_ms']:.4f}, floor "
                  f"{r['floor_ms']:.4f} / {r['floor_device_ms']:.4f}")
        tools["probe_times"] = probes
        tool_summary["probe_mosaic"].update(
            device_ms=sums["kernel_device_ms"], floor_ms=sums["floor_ms"],
            floor_device_ms=sums["floor_device_ms"],
            library_device_ms=sums["expr_device_ms"])
        tools["phase_s"] = time.perf_counter() - t9
        print(f"[9] phase 9 took {tools['phase_s']:.1f} s", flush=True)

        print("[10] the pipelined step as CUDA graphs against the eager loop", flush=True)
        t10 = time.perf_counter()
        graph = {}
        with tempfile.TemporaryDirectory() as tmp, env_var("PCRL_CONV3D", "pallas"):
            for name, amp in (("f32", False), ("amp", True)):
                graph[name] = g = graph_identity(amp, os.path.join(tmp, name))
                print(f"[10] {name}: {g['steps']} steps over two epochs (a new LR in the "
                      f"second), {g['graphs']} graphs, captured in "
                      f"{[round(c, 4) for c in g['capture_s']]} s: all {g['leaves']} leaves "
                      f"(parameters, BN statistics, momentum, step counter, generators, "
                      f"metrics) bit-identical to the eager loop; launches {g['counts']}; "
                      f"then {SYNC_STEPS} steps under set_sync_debug_mode('error'), host s a "
                      f"step: eager {[round(x, 4) for x in g['host_s_eager']]}, graph "
                      f"{[round(x, 5) for x in g['host_s_graph']]}", flush=True)
            graph["resume"] = r = graph_resume_check(os.path.join(tmp, "resume"))
            print(f"[10] --amp on the graphs, saved after epoch 0 and resumed: equal to the "
                  f"unbroken run after {r['steps']} steps ({r['graphs']} graphs in the "
                  f"resumed run)", flush=True)
        graph["phase_s"] = time.perf_counter() - t10
        print(f"[10] phase 10 took {graph['phase_s']:.1f} s", flush=True)

        print("[11] the rest of the 3D pretask surface", flush=True)
        t11 = time.perf_counter()
        surface = {}
        with tempfile.TemporaryDirectory() as tmp, env_var("PCRL_CONV3D", "pallas"):
            surface["identity"] = g = graph_identity(True, tmp, **FLAGS_IDENTITY)
        print(f"[11] --amp {' '.join(f'{k}={v}' for k, v in FLAGS_IDENTITY.items())}: "
              f"{g['steps']} steps, {g['graphs']} graphs: all {g['leaves']} leaves bit-identical "
              f"to the eager loop; launches {g['counts']}; losses "
              f"{[round(x, 5) for x in g['losses']]}", flush=True)
        for name, extra, affine in FLAG_RUNS:
            with tempfile.TemporaryDirectory() as tmp, env_var("PCRL_AFFINE", affine):
                runs[name] = r = run_cli("pallas", True, tmp, extra=extra)
                with env_var("PCRL_CONV3D", "pallas"):
                    profiles[name] = p = profile_cli(
                        cli_argv(True, os.path.join(tmp, "prof"), PROFILE_STEPS) + extra,
                        r["step_s_median"])
            print(f"[11] CLI --amp {' '.join(extra)} PCRL_AFFINE={affine}: launches "
                  f"{ {k: v / STEPS for k, v in r['counts'].items()} } per step, step s "
                  f"{[round(x, 4) for x in r['step_s']]} (median after {WARMUP}: "
                  f"{r['step_s_median']:.4f}; without: {runs['amp']['step_s_median']:.4f}), "
                  f"losses {[round(x, 5) for x in r['losses']]}, peak {r['peak_mem_gib']:.2f} GiB",
                  flush=True)
            print_profile(name, p)
        with tempfile.TemporaryDirectory() as tmp, env_var("PCRL_CONV3D", "pallas"):
            surface["disk_flags"] = d = flagged_disk_run(tmp)
        print(f"[11] CLI --data <structured phantom tree> --b {BATCH} {' '.join(FLAGS)}: "
              f"{len(d['losses'])} steps on the native reader, losses "
              f"{[round(x, 5) for x in d['losses']]}, launches {d['counts']}", flush=True)
        surface["bench"] = benches = run_bench()
        for name, r in benches.items():
            print(f"[11] bench {name}: {r['value']} {r['unit']} (trials {r['trials']}"
                  f"{', ' + r['spread_warning'] if 'spread_warning' in r else ''}), peak "
                  f"{r['peak_memory_gib']:.2f} GiB, batch {r['batch']} {r['compute_dtype']}, "
                  f"{r['device']}, {r['wall_s']:.1f} s", flush=True)
        surface["phase_s"] = time.perf_counter() - t11
        print(f"[11] phase 11 took {surface['phase_s']:.1f} s", flush=True)

        print("[12] the 2D chest path (--d 2 --n chest)", flush=True)
        t12 = time.perf_counter()
        chest = {}
        f32_2d, bf16_2d = model2d_reference_check()
        chest["model_check"] = {"f32": f32_2d, "bf16": bf16_2d}
        print(f"[12] PCRLv2 forward on the card vs CPU (of the largest entry): f32 " + ", ".join(
            f"{k} {v:.2e}" for k, v in f32_2d.items()) + "; bf16 from the CPU's f32 vs limit: "
            + ", ".join(f"{k} {v['card_vs_cpu_f32']:.2e} vs {v['limit']:.2e}"
                        for k, v in bf16_2d.items()), flush=True)
        for name, amp in (("f32", False), ("amp", True)):
            with tempfile.TemporaryDirectory() as tmp:
                chest[name] = r = run_cli2d(amp, tmp)
                profiles["chest_" + name] = p = profile_cli(
                    cli2d_argv(amp, os.path.join(tmp, "prof"), PROFILE_STEPS),
                    r["step_s_median"], groups=GROUPS2D)
            print(f"[12] CLI --d 2 --n chest --b {BATCH2D}{' --amp' if amp else ''}: launches "
                  f"of #1-#10 all 0, step s {[round(x, 4) for x in r['step_s']]} (median after "
                  f"{WARMUP}: {r['step_s_median']:.4f}), DT {[round(x, 4) for x in r['dt_s']]}, "
                  f"captures {[round(c, 3) for c in r['capture_s']]} s, losses "
                  f"{[round(x, 5) for x in r['losses']]}, peak {r['peak_mem_gib']:.2f} GiB",
                  flush=True)
            print_profile("chest_" + name, p)
        with tempfile.TemporaryDirectory() as tmp:
            for name, amp in (("f32", False), ("amp", True)):
                chest["identity_" + name] = g = graph_identity2d(amp, os.path.join(tmp, name))
                print(f"[12] 2D {name}: {g['steps']} steps over two epochs, {g['graphs']} graphs "
                      f"captured in {[round(c, 3) for c in g['capture_s']]} s: all {g['leaves']} "
                      f"leaves bit-identical to the eager loop, no kernel of #1-#10 launched; "
                      f"then {SYNC_STEPS} steps under set_sync_debug_mode('error'), host s a "
                      f"step: eager {[round(x, 4) for x in g['host_s_eager']]}, graph "
                      f"{[round(x, 5) for x in g['host_s_graph']]}", flush=True)
        chest["sync_free_step"] = sync2d = sync_free_step2d()
        print(f"[12] one 2D train_step under set_sync_debug_mode('error'): no sync; loss "
              f"{sync2d['loss']:.5f}, host {sync2d['host_s']:.4f} s to enqueue", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            chest["disk"] = d = run_disk2d(tmp)
        print(f"[12] 2D disk CLI ({CHEST_IMAGES} 1024² images, "
              f"{'PNGs decoded by Pillow' if d['pillow'] else 'cache entries written here'}): "
              f"epochs 0-1 trained, evaluated and saved, resumed at epoch 2; reads "
              f"{d['reads']} (the resumed run decoded none); step s "
              f"{[[round(x, 4) for x in e] for e in d['step_s']]}, DT "
              f"{[[round(x, 4) for x in e] for e in d['dt_s']]}; eval losses "
              f"{[round(e['loss'], 5) for e in d['evals']]}", flush=True)
        chest["bench"] = benches2d = run_bench2d()
        for name, r in benches2d.items():
            print(f"[12] bench {name}: {r['value']} {r['unit']} (trials {r['trials']}"
                  f"{', ' + r['spread_warning'] if 'spread_warning' in r else ''}), peak "
                  f"{r['peak_memory_gib']:.2f} GiB, batch {r['batch']} {r['compute_dtype']}, "
                  f"{r['device']}, {r['wall_s']:.1f} s", flush=True)
        chest["phase_s"] = time.perf_counter() - t12
        print(f"[12] phase 12 took {chest['phase_s']:.1f} s", flush=True)

        ft = finetune_phase(profiles)

        kernels = [kernel_entry(name, src, replaces, runs[LAUNCHED_IN[name]]["counts"][name],
                                summary[name]) for name, (src, replaces) in KERNELS.items()]
        kernels += [kernel_entry(name, src, replaces, tools["counts"][name], tool_summary[name])
                    for name, (src, replaces) in TOOL_KERNELS.items()]
        with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as fh:
            json.dump({"card": card, "build_s": {k: v[0] for k, v in report.items()},
                       "spills": spilled, "rows": rows, "odd_rows": odd_rows,
                       "in_channels": in_ch,
                       "model_check": {"f32_max_abs_err": err, "bf16": bf16_model},
                       "runs": runs, "sync_free_step": sync, "profiles": profiles,
                       "summary": summary, "tools": tools, "tool_rows": tool_rows,
                       "tool_odd_rows": tool_odd_rows, "tool_summary": tool_summary,
                       "graph": graph, "surface": surface, "chest": chest,
                       "finetune": ft}, fh,
                      indent=1)
    except Exception:  # noqa: BLE001 — report any phase's failure and exit 1
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(lock_dir, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
