"""PCRLv23d — 3D UNet with multi-scale self-supervised heads (port of
``pcrlv2_tpu/models/unet3d.py``; reference ``pcrlv2_model_3d.py:95-133``).

Encoder: 4 stages of 2×LUConv, channels 1→(32→64)→(64→128)→(128→256)→
(256→512), 2³ max pool between stages.  Decoder: 3 stages of a k2s2
transpose conv + 2×LUConv, 512→256→128→64, each with three heads (GAP→BN1d
projection, MLP predictor, Co=1 sigmoid mask).  No skip connections.  Output:
1³ conv + sigmoid.

Activations are NDHWC (input (B, X, Y, Z, 1)); ``state_dict()`` is exactly
the reference ``PCRLv23d`` schema.  Train/eval mode is the module's
``training`` flag.  ``remat=True`` recomputes each transition's activations
in the backward instead of keeping them (flax ``nn.remat``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from pcrlv2_tpu_torch.models.layers import (BatchNorm, Conv3d, ConvTranspose3d,
                                            MLPHead, PReLU, make_act, make_norm, recomputing)
from pcrlv2_tpu_torch.ops.pooling import global_avg_pool, max_pool3d
from pcrlv2_tpu_torch.ops.resize import upsample_linear


class LUConv(nn.Module):
    """Conv3d(3³, pad 1) → Norm → Act (reference ``pcrlv2_model_3d.py:6-34``)."""

    def __init__(self, cin: int, features: int, act: str, norm: str,
                 policy: Policy, gen: torch.Generator):
        super().__init__()
        self.conv1 = Conv3d(cin, features, 3, policy, gen)
        self.bn1 = make_norm(norm, features, policy)
        if act == "prelu":
            self.activation = PReLU(features, policy)
        else:
            self.act_fn = make_act(act)

    def forward(self, x):
        x = self.bn1(self.conv1(x))
        return self.activation(x) if hasattr(self, "activation") else self.act_fn(x)


class DownTransition(nn.Module):
    """2×LUConv: cin → 32·2^depth → 64·2^depth."""

    def __init__(self, cin: int, depth: int, act: str, norm: str,
                 policy: Policy, gen: torch.Generator):
        super().__init__()
        c = 32 * 2 ** depth
        self.ops = nn.ModuleList([LUConv(cin, c, act, norm, policy, gen),
                                  LUConv(c, 2 * c, act, norm, policy, gen)])

    def forward(self, x):
        return self.ops[1](self.ops[0](x))


class UpTransition(nn.Module):
    """k2s2 transpose conv + 2×LUConv + the three SSL heads
    (reference ``pcrlv2_model_3d.py:48-72``)."""

    def __init__(self, cin: int, out_chans: int, depth: int, act: str,
                 norm: str, policy: Policy, gen: torch.Generator):
        super().__init__()
        channels = 32 * 2 ** depth * 2
        self.up_conv = ConvTranspose3d(cin, out_chans, policy, gen)
        self.ops = nn.ModuleList([
            LUConv(out_chans, channels, act, norm, policy, gen),
            LUConv(channels, channels, act, norm, policy, gen)])
        self.bn = BatchNorm(channels, policy)
        self.predictor_head = MLPHead(channels, policy, gen)
        self.deep_supervision_head = LUConv(channels, 1, "sigmoid", norm,
                                            policy, gen)

    def forward(self, x):
        x = self.ops[1](self.ops[0](self.up_conv(x)))
        x_pro = self.bn(global_avg_pool(x))
        x_pre = self.predictor_head(x_pro)
        x_mask = self.deep_supervision_head(x)
        return x, x_pro, x_pre, x_mask


class PCRLv23d(nn.Module):
    """``forward(x, local=False)`` with x (B, X, Y, Z, C_in) returns
    ``(out, middle_features, middle_masks)``:

    * ``out``: (B, X, Y, Z, n_class) sigmoid restoration mask;
    * ``middle_features``: 3 ``(pro, pre)`` pairs, dims 256/128/64, deep→shallow;
    * ``middle_masks``: 3 masks, trilinearly upsampled to the input size
      (native decoder sizes with ``upsample_masks=False``); empty when
      ``local``.  The mask heads run either way (their BN statistics update).

    Built on ``device`` (default: CUDA, raising without it) with weights
    drawn from ``seed``.  ``remat``: each ``DownTransition`` and
    ``UpTransition`` runs under a recomputing checkpoint when gradients are
    recorded (the JAX ``PCRLv23d(remat=True)``); the modules, and so the
    ``state_dict`` keys, stay as they are.
    """

    #: SimSiam levels (decoder stages) and the spatial rank of the input
    n_levels = 3
    dim = 3

    def __init__(self, n_class: int = 1, act: str = "relu", norm: str = "bn",
                 in_channels: int = 1, policy: Policy = DEFAULT_POLICY,
                 upsample_masks: bool = True, seed: int = 0, device=None,
                 remat: bool = False):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.policy = policy
        self.upsample_masks = upsample_masks
        self.remat = remat
        self.down_tr64 = DownTransition(in_channels, 0, act, norm, policy, gen)
        self.down_tr128 = DownTransition(64, 1, act, norm, policy, gen)
        self.down_tr256 = DownTransition(128, 2, act, norm, policy, gen)
        self.down_tr512 = DownTransition(256, 3, act, norm, policy, gen)
        self.up_tr256 = UpTransition(512, 512, 2, act, norm, policy, gen)
        self.up_tr128 = UpTransition(256, 256, 1, act, norm, policy, gen)
        self.up_tr64 = UpTransition(128, 128, 0, act, norm, policy, gen)
        self.out_tr = nn.Module()
        self.out_tr.final_conv = Conv3d(64, n_class, 1, policy, gen)
        self.to(dev)

    def transition(self, module: nn.Module, x):
        """``module(x)``; under ``remat`` with gradients recorded, a
        non-reentrant checkpoint that keeps none of its activations and runs
        it again inside the backward.  The transitions draw nothing random,
        so no RNG state is saved (reading the CUDA generator's state is not
        allowed inside a graph capture); the run again is ``recomputing``, so
        its BatchNorms advance their running statistics once."""
        if not (self.remat and torch.is_grad_enabled()):
            return module(x)
        return checkpoint(module, x, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), recomputing(module)))

    def forward(self, x, local: bool = False):
        x = self.policy.cast_to_compute(x)
        run = self.transition
        skip64 = run(self.down_tr64, x)
        skip128 = run(self.down_tr128, max_pool3d(skip64))
        skip256 = run(self.down_tr256, max_pool3d(skip128))
        out512 = run(self.down_tr512, max_pool3d(skip256))
        out256, pro256, pre256, mask256 = run(self.up_tr256, out512)
        out128, pro128, pre128, mask128 = run(self.up_tr128, out256)
        out64, pro64, pre64, mask64 = run(self.up_tr64, out128)
        middle_masks = []
        if not local:
            if self.upsample_masks:
                middle_masks = [upsample_linear(mask256, 4),
                                upsample_linear(mask128, 2), mask64]
            else:
                middle_masks = [mask256, mask128, mask64]
        middle_features = [(pro256, pre256), (pro128, pre128), (pro64, pre64)]
        out = torch.sigmoid(self.out_tr.final_conv(out64))
        return out, middle_features, middle_masks
