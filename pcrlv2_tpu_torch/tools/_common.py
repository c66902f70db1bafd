"""What the kernel prototype tools share: the device set-up, the timer and
the error measure, and the ``Case`` each tool yields per kernel launch shape
(its ``main()`` and ``chip_smoke.py`` phase 9 both walk them)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pcrlv2_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class Case:
    """One kernel launch shape: the kernel's call, its plain version and the
    one PyTorch call that computes the same function (a yardstick, never
    used by the port), on the same inputs; ``flops`` and ``nbytes`` are the
    function's useful work (each input read once, each output written once);
    ``product_flops``, where it differs, the work of the formulation itself
    (the banded product's, zeros included)."""

    kernel: str
    label: str
    run: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Callable[[], torch.Tensor]
    flops: float
    nbytes: float
    product_flops: float | None = None


def setup(device) -> torch.device:
    """The tool's device (CUDA unless ``device="cpu"``; raises without CUDA
    otherwise), with TF32 off so that f32 products are f32; prints it."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    return dev


def time_ms(fn, device: torch.device, reps: int = 5) -> float | None:
    """Milliseconds per call of ``fn`` on the card (CUDA events over ``reps``
    calls after one warm-up call); None on the CPU, where no device time
    exists."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|, in f32."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)


def fmt_ms(ms: float | None) -> str:
    return "not timed (cpu)" if ms is None else f"{ms:8.3f} ms"


def tflops(flops: float, ms: float | None) -> str:
    return "" if ms is None else f" {flops / ms / 1e9:6.1f} TF"
