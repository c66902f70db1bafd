"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU by name.
Without a CUDA device and without that request they raise: a run never
continues on the CPU by accident.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device (raises without one);
    ``"cpu"`` → the CPU; any other torch device string is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU")
    return dev


def on_device(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` as a tensor on ``device``: a tensor as it is; a Python
    number or list as a ``dtype`` tensor copied there without waiting for
    the device (a step's inputs: the trainer passes device tensors, callers
    and tests may pass numbers)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor(value, dtype=dtype).to(device, non_blocking=True)
