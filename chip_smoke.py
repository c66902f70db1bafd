#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pcrlv2_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero without the final line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``pcrlv2_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time and ``ptxas`` report;
3. hold every kernel against its plain PyTorch version at every shape the
   3D pretraining path gives it, in f32 (TF32 off) and bf16;
4. time each kernel, its plain version and, as a yardstick only, the one
   PyTorch call that computes the same function (cuDNN);
5. check a small forward of the model on the card against the same weights
   on the CPU;
6. run the port's CLI at full width (``--synthetic --d 3 --b 4 --epochs 0
   --steps_per_epoch 10``) in f32 and with ``--amp``, with every launch
   counter set to 0 just before and read just after; every loss must be
   finite, every kernel launched, and the ``.pt`` must load strictly.  The
   step time is the median over the steps after the first ``WARMUP`` of
   each step's own time, recovered from the running average ``BT`` that the
   CLI logs after every step;
7. run the same CLI path (``cli.main.prepare`` → ``run_training``) again
   under ``torch.profiler`` for the device time per step by kernel group,
   over ``PROFILED`` steps after the first ``WARMUP``, and the device's
   busy share (that time over the unprofiled step time).

Prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.  Per-shape results (errors, times,
bounds), the CLI runs and the profiles go to
``chiprun_out/chip_smoke_kernels.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
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
STEPS = 10     # CLI steps per precision (phase 6)
WARMUP = 3     # first CLI steps left out of the step time and the profile
PROFILED = 4   # steps under the profiler (phase 7)
# (batch, input size): the two global views run at B each, the 6 local
# views concatenated at 6·B
CALLS = {"global": (BATCH, (64, 64, 32)), "local": (6 * BATCH, (16, 16, 16))}

#: device-kernel name fragment → group reported by phase 7
GROUPS = [("conv3d_fwd_kernel", "conv3d_fwd (#1, fwd and dx)"),
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
}


def level_shape(call: str, level: int):
    b, size = CALLS[call]
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


def conv_cases(dtype):
    """(kernel, label, kernel_fn, plain_fn, library_fn, flops, bytes, kinds)
    for every conv launch shape of one training step; ``kinds`` names each
    output's tolerance class."""
    import torch
    import torch.nn.functional as F

    from pcrlv2_tpu_torch.ops import conv3d_kernel as ck

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    es = torch.tensor([], dtype=dtype).element_size()
    for call in CALLS:
        for name, ci, co, level in CONVS:
            shp = level_shape(call, level)
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
            yield ("conv3d_fwd", label + " fwd",
                   lambda x=x, wm=wm, bias=bias: ck.conv3d_fwd(x, wm, bias),
                   lambda x=x, wm=wm, bias=bias: ck.conv3d_fwd_plain(x, wm, bias),
                   lambda x_nc=x_nc, w_nc=w_nc, bias=bias: F.conv3d(x_nc, w_nc, bias, padding=1),
                   flops, es * (m * (ci + co) + 27 * ci * co + co), ("out",))
            if name != "down_tr64.ops.0":  # the stem's input needs no gradient
                yield ("conv3d_fwd", label + " dx",
                       lambda g=g, wt=wt: ck.conv3d_fwd(g, wt, None),
                       lambda g=g, wt=wt: ck.conv3d_fwd_plain(g, wt, None),
                       lambda f=lib_bwd: f([True, False, False]),
                       flops, es * (m * (ci + co) + 27 * ci * co), ("out",))
            yield ("conv3d_dw", label + " dw",
                   lambda x=x, g=g: ck.conv3d_dw(x, g),
                   lambda x=x, g=g: ck.conv3d_dw_plain(x, g),
                   lambda f=lib_bwd: f([False, True, False]),
                   flops, es * m * (ci + co) + 4 * 27 * ci * co, ("dw",))


def head_cases(dtype):
    import torch
    import torch.nn.functional as F

    from pcrlv2_tpu_torch.ops import head_conv as hc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    es = torch.tensor([], dtype=dtype).element_size()
    for call in CALLS:
        for name, ci, level in HEADS:
            shp = level_shape(call, level)
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


def rel_err(got, ref):
    """(max |got − ref| / max |ref|, max |got − ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err / max(ref.float().abs().max().item(), 1e-30), err


def check_and_time(results):
    """Phases 3 and 4: every kernel against its plain version at every shape,
    in f32 and bf16; kernel, plain and library times in f32, kernel in bf16.
    A kernel's summary sums one launch at each of its main-path shapes."""
    import torch

    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "shapes": 0}
               for k in KERNELS}
    failures = []
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
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
                       "ops_ms": 1e3 * flops / PEAK_FLOPS[dname],
                       "bytes_ms": 1e3 * nbytes / HBM_BYTES_S}
                row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
                if dname == "float32":
                    row["plain_ms"] = time_ms(pfn, reps=2)
                    row["library_ms"] = time_ms(lfn)
                    s = summary[kernel]
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                "ops_ms", "bytes_ms"):
                        s[key] += row[key]
                    s["shapes"] += 1
                results.append(row)
                worst[dname] = max(worst.get(dname, 0.0), rel)
                if not ok:
                    failures.append(f"{dname} {label}: rel err {row['rel_err']} > {tols}")
        print(f"  {dname}: {sum(r['dtype'] == dname for r in results)} launches checked, "
              f"largest error {worst[dname]:.2f} of its tolerance", flush=True)
    return summary, failures


def model_reference_check():
    """A small train-mode forward on the card (kernels) against the same
    weights on the CPU (plain versions), f32."""
    import torch

    from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d

    gpu = PCRLv23d(policy=PARITY_POLICY, seed=5, device="cuda")
    cpu = PCRLv23d(policy=PARITY_POLICY, seed=5, device="cpu")
    x = torch.rand(2, 16, 16, 8, 1, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        out_g, feats_g, masks_g = gpu(x.to("cuda"))
        out_c, feats_c, masks_c = cpu(x)
    errs = [(a.cpu() - b).abs().max().item()
            for a, b in [(out_g, out_c)] + list(zip(masks_g, masks_c))]
    if max(errs) > 1e-4 or not all(math.isfinite(e) for e in errs):
        raise AssertionError(f"model on the card vs CPU: max err {max(errs):.3e} > 1e-4")
    return max(errs)


def cli_argv(amp: bool, out_dir: str, steps: int):
    return (["--synthetic", "--d", "3", "--phase", "pretask", "--b", str(BATCH),
             "--epochs", "0", "--steps_per_epoch", str(steps), "--log_every", "1",
             "--seed", "0", "--output", out_dir] + (["--amp"] if amp else []))


def run_cli(amp: bool, out_dir: str):
    """Phase 6: the port's CLI in this process, counters read around it."""
    import torch

    from pcrlv2_tpu_torch.cli.main import main as cli_main
    from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
    from pcrlv2_tpu_torch.ops import _build
    from pcrlv2_tpu_torch.train.checkpoint import import_pcrlv23d

    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    cli_main(cli_argv(amp, out_dir, STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: _build.launches[k] for k in KERNELS}
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"main path ({'amp' if amp else 'f32'}) launched no {missing}")
    rows = [json.loads(s) for s in open(os.path.join(out_dir, "metrics.jsonl"))]
    steps = [r for r in rows if "iter" in r]
    if len(steps) != STEPS:
        raise AssertionError(f"expected {STEPS} logged steps, got {len(steps)}")
    for r in steps:
        for k in ("loss", "mg_loss", "cos_loss", "local_loss"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"non-finite {k} at step {r['iter']}: {r[k]}")
        if r["skipped"]:
            raise AssertionError(f"step {r['iter']} was skipped by the loss guard")
    fresh = PCRLv23d(device="cuda", seed=1)
    import_pcrlv23d(os.path.join(out_dir, "pcrlv2_luna_pretask_1.0_0.pt"), fresh)
    # BT is the running average over the epoch's steps (log_every=1)
    avg = [r["BT"] for r in steps]
    step_s = [avg[0]] + [(k + 1) * avg[k] - k * avg[k - 1] for k in range(1, len(avg))]
    return {"counts": counts, "wall_s": wall, "step_s": step_s,
            "step_s_median": statistics.median(step_s[WARMUP:]),
            "losses": [r["loss"] for r in steps],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


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


def profile_cli(amp: bool, out_dir: str, step_s: float):
    """Phase 7: the CLI's training path under ``torch.profiler``; the loader
    marks each step's start (after a device sync), and the profile holds
    ``PROFILED`` steps after the first ``WARMUP``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from pcrlv2_tpu_torch.cli.main import prepare
    from pcrlv2_tpu_torch.train.trainer import run_training

    model, cfg, loader, aug_fn, device = prepare(
        cli_argv(amp, out_dir, WARMUP + PROFILED + 1))

    class StepMarked:
        def epoch(self, epoch):
            for batch in loader.epoch(epoch):
                torch.cuda.synchronize()
                prof.step()
                yield batch

    # profiler period 0 ends at the first batch, so period k is step k − 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=WARMUP, warmup=1, active=PROFILED,
                                   repeat=1)) as prof:
        run_training(model, cfg, StepMarked(), aug_fn, device)
    # the profiler's own step annotation also shows as a device entry
    kernels = [(e.key, _kernel_us(e), e.count) for e in prof.key_averages()
               if _kernel_us(e) > 0 and not e.key.startswith("ProfilerStep")]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernel")
    busy_ms = sum(us for _, us, _ in kernels) / 1e3 / PROFILED
    groups = {label: 0.0 for _, label in GROUPS}
    groups["other"] = 0.0
    for name, us, _ in kernels:
        label = next((lab for frag, lab in GROUPS if frag in name.lower()), "other")
        groups[label] += us / 1e3 / PROFILED
    return {"device_ms_per_step": busy_ms, "busy_share": busy_ms / 1e3 / step_s,
            "ms_per_step_by_group": groups,
            "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / PROFILED,
                             "launches_per_step": c / PROFILED}
                            for n, us, c in sorted(kernels, key=lambda k: -k[1])[:15]]}


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
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout.strip()
        card = smi.splitlines()[0]
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

        print("[3,4] kernels vs plain versions at the main-path shapes", flush=True)
        rows = []
        summary, failures = check_and_time(rows)
        if failures:
            raise AssertionError("kernel disagrees with its plain version:\n  "
                                 + "\n  ".join(failures))

        err = model_reference_check()
        print(f"[5] model forward on the card vs CPU: max abs err {err:.2e}")

        runs = {}
        for amp in (False, True):
            with tempfile.TemporaryDirectory() as tmp:
                runs["amp" if amp else "f32"] = r = run_cli(amp, tmp)
            print(f"[6] CLI {'--amp' if amp else 'f32'}: launches {r['counts']}, "
                  f"step s {[round(s, 4) for s in r['step_s']]} (median after "
                  f"{WARMUP}: {r['step_s_median']:.4f}), losses "
                  f"{[round(x, 5) for x in r['losses']]}, peak {r['peak_mem_gib']:.2f} GiB",
                  flush=True)

        profiles = {}
        for amp in (False, True):
            name = "amp" if amp else "f32"
            with tempfile.TemporaryDirectory() as tmp:
                profiles[name] = p = profile_cli(amp, tmp, runs[name]["step_s_median"])
            print(f"[7] profile {name}: device {p['device_ms_per_step']:.2f} ms/step, "
                  f"busy {p['busy_share']:.1%}; " + ", ".join(
                      f"{k} {v:.2f}" for k, v in sorted(
                          p["ms_per_step_by_group"].items(), key=lambda kv: -kv[1])),
                  flush=True)

        kernels = []
        for name, (src, replaces) in KERNELS.items():
            s = summary[name]
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces, "launches": runs["f32"]["counts"][name],
                            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                            "bound_by": ("operations" if s["ops_ms"] >= s["bytes_ms"]
                                         else "bytes"),
                            "library_ms": s["library_ms"]})
        with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as fh:
            json.dump({"card": card, "build_s": {k: v[0] for k, v in report.items()},
                       "rows": rows, "runs": runs, "profiles": profiles,
                       "summary": summary}, fh, indent=1)
    except Exception:  # noqa: BLE001 — report any phase's failure and exit 1
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
