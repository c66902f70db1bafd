"""Gradient accuracy of the PyTorch port and of the JAX package against a
float64 run of the JAX model, on the CPU.

Both f32 implementations get the same weights and input; the loss is a fixed
random projection of the level-0 predictor output (the path where the two
f32 gradients disagree most at the test size).  Prints, per parameter
tensor, the largest gradient error of each as a fraction of the tensor's
largest float64 gradient entry.

    JAX_PLATFORMS=cpu python tools/port_grad_vs_f64.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pcrlv2_tpu.core.precision import PARITY_POLICY, Policy  # noqa: E402
from pcrlv2_tpu.models import PCRLv23d as JaxPCRLv23d  # noqa: E402
from pcrlv2_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from pcrlv2_tpu_torch.core.precision import PARITY_POLICY as TORCH_PARITY  # noqa: E402
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d  # noqa: E402
from pcrlv2_tpu_torch.train.checkpoint import from_jax_variables  # noqa: E402

F64 = Policy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
             output_dtype=jnp.float64)
SHAPE = (4, 16, 16, 8, 1)
_FEED_BN = ("conv1.bias", "predictor_head.0.bias", ".bn.bias")


def main() -> None:
    m32, m64 = JaxPCRLv23d(policy=PARITY_POLICY), JaxPCRLv23d(policy=F64)
    variables = m32.init(jax.random.key(0), jnp.zeros(SHAPE, jnp.float32))
    params, stats = variables["params"], variables["batch_stats"]
    x = np.random.RandomState(0).rand(*SHAPE).astype(np.float32)
    proj = np.random.RandomState(1).randn(SHAPE[0], 256).astype(np.float32)

    def loss(model, p, xx):
        (_, feats, _), _ = model.apply({"params": p, "batch_stats": stats}, xx,
                                       train=True, mutable=["batch_stats"])
        return jnp.sum(feats[0][1] * proj)

    g32 = jax.grad(lambda p: loss(m32, p, jnp.asarray(x)))(params)
    g64 = jax.grad(lambda p: loss(m64, p, jnp.asarray(x, jnp.float64)))(
        jax.tree.map(lambda a: a.astype(jnp.float64), params))

    def to_torch(g):
        return jax_ckpt.flax_to_torch_state(
            {"params": jax.tree.map(lambda a: np.asarray(a, np.float64), g),
             "batch_stats": stats}, jax_ckpt.pcrlv23d_mapping())

    t32, t64 = to_torch(g32), to_torch(g64)
    model = PCRLv23d(policy=TORCH_PARITY, device="cpu")
    model.load_state_dict(from_jax_variables(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, stats)}))
    model.train()
    _, feats, _ = model(torch.from_numpy(x))
    (feats[0][1] * torch.from_numpy(proj)).sum().backward()
    rows = []
    for name, p in model.named_parameters():
        ref = np.asarray(t64[name], np.float64)
        scale = np.abs(ref).max()
        if p.grad is None or scale == 0 or name.endswith(_FEED_BN):
            continue  # these biases feed a BatchNorm: their true gradient is 0
        rows.append((np.abs(t32[name] - ref).max() / scale,
                     np.abs(p.grad.double().numpy() - ref).max() / scale, name))
    print(f"{'tensor':44s} {'jax f32':>10s} {'port f32':>10s}")
    for jerr, perr, name in sorted(rows, reverse=True)[:8]:
        print(f"{name:44s} {jerr:10.2e} {perr:10.2e}")


if __name__ == "__main__":
    main()
