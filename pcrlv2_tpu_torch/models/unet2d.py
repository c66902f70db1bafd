"""PCRLv2 — the 2D ResNet-18 U-Net with multi-scale self-supervised heads
(port of ``pcrlv2_tpu/models/unet2d.py``; reference ``pcrlv2_model.py:197-209``).

* Encoder: ``ResNet18Encoder`` (smp ``Unet('resnet18')``'s).
* Decoder: 5 ``DecoderBlock``s, channels (256, 128, 64, 32, 16) from the
  encoder's 512-channel head; no skip connections (commented out in the
  reference, ``:115-117``); smp's ``Attention`` is ``None`` there, identity.
* A ``DecoderBlock`` (reference ``:68-128``): ×2 nearest upsample → 2×(3×3
  conv + BN + ReLU) → heads: deep-supervision mask (3×3 conv + BN + ReLU +
  1×1 conv → 3 channels; not run on local views, as in the JAX package),
  GAP → BN1d projection ``x_pro``, MLP predictor ``x_pre``.
* Middle masks bilinearly upsampled ×2^(4−i) to the input size.
* Segmentation head: 3×3 conv 16 → ``n_class``, not run on local views.

``forward(x, local=False)`` with x (B, H, W, 3) returns ``(decoder_outputs,
masks, middle_masks)``: 5 ``(pro, pre)`` pairs deep→shallow, the
segmentation output (None when ``local``) and 5 masks (empty when
``local``) — the reference's order (``pcrlv2_model.py:209``), not the 3D
model's.  Activations are NHWC; ``state_dict()`` has the reference model's
key names (``model.encoder.*``, ``model.decoder.blocks.{i}.*``,
``model.segmentation_head.0.*``; ``train/checkpoint.py::pcrlv2_2d_mapping``).

Building it on a CUDA device sets cuDNN as the 2D path needs it
(``ops.convolution.deterministic_cudnn``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcrlv2_tpu_torch.core.device import resolve_device
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from pcrlv2_tpu_torch.models.layers import BatchNorm, Conv2d, MLPHead
from pcrlv2_tpu_torch.models.resnet import ResNet18Encoder
from pcrlv2_tpu_torch.ops.convolution import deterministic_cudnn
from pcrlv2_tpu_torch.ops.pooling import global_avg_pool
from pcrlv2_tpu_torch.ops.resize import upsample_linear, upsample_nearest2x_2d

DECODER_CHANNELS = (256, 128, 64, 32, 16)


def _conv_bn_relu(cin: int, features: int, policy: Policy, gen: torch.Generator):
    """smp ``Conv2dReLU``: Sequential(3×3 conv without bias, BN, ReLU) — its
    children ``0`` and ``1``."""
    return nn.ModuleList([Conv2d(cin, features, 3, policy, gen, init="kaiming_uniform_relu"),
                          BatchNorm(features, policy)])


class DecoderBlock(nn.Module):
    """Reference ``pcrlv2_model.py:68-128``, decoder-initialized (kaiming-
    uniform-ReLU convs, xavier Linears, zero biases; ``:23-38``)."""

    def __init__(self, cin: int, features: int, policy: Policy, gen: torch.Generator):
        super().__init__()
        self.conv1 = _conv_bn_relu(cin, features, policy, gen)
        self.conv2 = _conv_bn_relu(features, features, policy, gen)
        # the reference's Sequential(conv, BN, ReLU, conv): children 0, 1, 3
        self.deep_supervision_head = nn.ModuleDict({
            "0": Conv2d(features, features, 3, policy, gen, bias=True,
                        init="kaiming_uniform_relu"),
            "1": BatchNorm(features, policy),
            "3": Conv2d(features, 3, 1, policy, gen, bias=True, init="kaiming_uniform_relu")})
        self.bn = BatchNorm(features, policy)
        self.predictor_head = MLPHead(features, policy, gen, decoder_init=True)

    def forward(self, x, local: bool = False):
        x = upsample_nearest2x_2d(x)
        for conv in (self.conv1, self.conv2):
            x = torch.relu(conv[1](conv[0](x)))
        x_mask = None
        if not local:
            head = self.deep_supervision_head
            x_mask = head["3"](torch.relu(head["1"](head["0"](x))))
        x_pro = self.bn(global_avg_pool(x))
        return x, x_pro, self.predictor_head(x_pro), x_mask


class PCRLv2(nn.Module):
    """The 2D model.  Built on ``device`` (default: CUDA, raising without it)
    with weights drawn from ``seed``; ``upsample_masks=False`` returns the
    middle masks at their native sizes (the step upsamples them)."""

    #: SimSiam levels (decoder stages) and the spatial rank of the input
    n_levels = len(DECODER_CHANNELS)
    dim = 2

    def __init__(self, n_class: int = 3, policy: Policy = DEFAULT_POLICY,
                 upsample_masks: bool = True, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.policy = policy
        self.upsample_masks = upsample_masks
        self.model = nn.Module()
        self.model.encoder = ResNet18Encoder(policy=policy, gen=gen)
        self.model.decoder = nn.Module()
        cins = (ResNet18Encoder.out_channels[-1],) + DECODER_CHANNELS[:-1]
        self.model.decoder.blocks = nn.ModuleList([
            DecoderBlock(cin, ch, policy, gen) for cin, ch in zip(cins, DECODER_CHANNELS)])
        self.model.segmentation_head = nn.ModuleList([
            Conv2d(DECODER_CHANNELS[-1], n_class, 3, policy, gen, bias=True, init="xavier")])
        self.to(dev)
        if dev.type == "cuda":
            deterministic_cudnn()

    @property
    def encoder(self) -> ResNet18Encoder:
        return self.model.encoder

    def forward(self, x, local: bool = False):
        x = self.model.encoder(x)[-1]
        decoder_outputs, middle_masks = [], []
        for i, block in enumerate(self.model.decoder.blocks):
            x, x_pro, x_pre, x_mask = block(x, local)
            decoder_outputs.append((x_pro, x_pre))
            if not local:
                middle_masks.append(upsample_linear(x_mask, 2 ** (4 - i))
                                    if self.upsample_masks else x_mask)
        masks = None if local else self.model.segmentation_head[0](x)
        return decoder_outputs, masks, middle_masks
