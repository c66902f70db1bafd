"""ResNet-18 encoder of the 2D model (port of ``pcrlv2_tpu/models/resnet.py``;
the reference's ``smp.Unet('resnet18')`` encoder, ``pcrlv2_model.py:200``).

torchvision ResNet-18 as a 6-stage feature pyramid, out channels (3, 64, 64,
128, 256, 512): [the input, conv1 + bn + relu (/2), maxpool + layer1 (/4),
layer2 (/8), layer3 (/16), layer4 (/32)].  Activations are NHWC;
``state_dict()`` carries torchvision's key names (``conv1.weight``,
``layer2.0.downsample.0.weight``, …), the schema of the reference's 2D
``.pt`` (``train_2d.py:99``), ``fc`` left out as smp's encoder leaves it.

Convs initialize as torchvision's from-scratch scheme (kaiming-normal fan-out,
BN γ = 1, β = 0); the reference starts from ImageNet weights, which no run
here can fetch: ``train/checkpoint.py::import_resnet18_encoder`` loads a
local torchvision state_dict instead (the CLI's ``--encoder_weights``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from pcrlv2_tpu_torch.models.layers import BatchNorm, Conv2d
from pcrlv2_tpu_torch.ops.pooling import max_pool2d

#: (width, stride) of layer1..layer4
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def _conv(cin: int, cout: int, k: int, policy: Policy, gen: torch.Generator,
          stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, policy, gen, stride=stride, init="kaiming_normal_fan_out")


class BasicBlock(nn.Module):
    """torchvision ``BasicBlock``: two 3×3 convs, identity or a 1×1
    ``downsample`` (conv, BN) where the stride or the width changes."""

    def __init__(self, cin: int, features: int, stride: int, policy: Policy,
                 gen: torch.Generator):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, policy, gen, stride)
        self.bn1 = BatchNorm(features, policy)
        self.conv2 = _conv(features, features, 3, policy, gen)
        self.bn2 = BatchNorm(features, policy)
        if stride != 1 or cin != features:
            self.downsample = nn.ModuleList([_conv(cin, features, 1, policy, gen, stride),
                                             BatchNorm(features, policy)])

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if hasattr(self, "downsample"):
            identity = self.downsample[1](self.downsample[0](x))
        return torch.relu(out + identity)


class ResNet18Encoder(nn.Module):
    """``forward(x)`` with x (B, H, W, C) returns the 6 features, the input
    first (not cast).  Built on ``device`` (default: CUDA, raising without
    it) with weights drawn from ``seed``, or from ``gen`` when a model
    builds it."""

    out_channels = (3, 64, 64, 128, 256, 512)

    def __init__(self, in_channels: int = 3, policy: Policy = DEFAULT_POLICY,
                 seed: int = 0, device=None, gen: torch.Generator | None = None):
        super().__init__()
        own = gen is None
        if own:
            gen = torch.Generator().manual_seed(seed)
        self.policy = policy
        self.conv1 = _conv(in_channels, 64, 7, policy, gen, stride=2)
        self.bn1 = BatchNorm(64, policy)
        cin = 64
        for i, (width, stride) in enumerate(STAGES, start=1):
            setattr(self, f"layer{i}", nn.ModuleList([
                BasicBlock(cin, width, stride, policy, gen),
                BasicBlock(width, width, 1, policy, gen)]))
            cin = width
        if own:
            self.to(resolve_device(device))

    def forward(self, x):
        feats = [x]
        x = torch.relu(self.bn1(self.conv1(self.policy.cast_to_compute(x))))
        feats.append(x)
        x = max_pool2d(x)
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                x = block(x)
            feats.append(x)
        return feats
