"""Mixed-precision policy (port of ``pcrlv2_tpu/core/precision.py``).

Parameters and optimizer state stay float32; with the default policy conv and
matmul inputs run in bfloat16 with float32 accumulation, and reductions
(batch-norm statistics, losses) accumulate in float32.  ``PARITY_POLICY`` is
all float32 and is what the parity tests and the default CLI use.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """What dtype each class of tensor uses.

    ``param_dtype``   — stored parameters / optimizer state.
    ``compute_dtype`` — conv/matmul inputs and the activations between layers.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


#: bf16 compute, f32 master weights (``--amp``).
DEFAULT_POLICY = Policy()

#: Full-f32 policy for parity against the JAX package.
PARITY_POLICY = Policy(param_dtype=torch.float32, compute_dtype=torch.float32)
