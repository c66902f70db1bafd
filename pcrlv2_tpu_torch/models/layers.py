"""Building blocks of the 3D and 2D models (port of
``pcrlv2_tpu/models/layers.py``).

Parameters keep the reference torch layouts and names; activations are
NDHWC / NHWC.  Initializers draw from the same distributions as the JAX
package (torch defaults; torchvision's and the 2D decoder's schemes for the
2D model, ``CONV2D_INITS``), from an explicit ``torch.Generator``.

Normalization follows flax, not ``torch.nn.BatchNorm``: the batch variance
is ``E[x²] − E[x]²`` clipped at 0, and the running variance is updated with
that *biased* variance (torch uses the unbiased one), momentum 0.9 on the
old value.  Statistics accumulate in f32; the output is in the compute dtype.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

from pcrlv2_tpu_torch.core import mesh
from pcrlv2_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from pcrlv2_tpu_torch.ops.convolution import conv2d, conv3d, conv_transpose3d


def _uniform(shape, bound: float, gen: torch.Generator) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=gen)
    return nn.Parameter(t)


def _normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    t.normal_(0.0, std, generator=gen)
    return nn.Parameter(t)


def _xavier(shape, gen: torch.Generator) -> nn.Parameter:
    """xavier_uniform over (out, in, *kernel): U(±√(6/(fan_in + fan_out)))."""
    field = math.prod(shape[2:])
    return _uniform(shape, math.sqrt(6.0 / ((shape[0] + shape[1]) * field)), gen)


#: weight initializers of ``Conv2d`` (the JAX package's ``kernel_init``s):
#: ``kaiming_normal_fan_out`` torchvision's ResNet init N(0, 2/fan_out)
#: (``pcrlv2_tpu/models/resnet.py:29``, a truncated normal there);
#: ``kaiming_uniform_relu`` the 2D decoder's U(±√(6/fan_in)); ``xavier`` the
#: segmentation head's
CONV2D_INITS = {
    "kaiming_normal_fan_out": lambda shape, gen: _normal(
        shape, math.sqrt(2.0 / (shape[0] * math.prod(shape[2:]))), gen),
    "kaiming_uniform_relu": lambda shape, gen: _uniform(
        shape, math.sqrt(6.0 / math.prod(shape[1:])), gen),
    "xavier": _xavier,
}


@contextlib.contextmanager
def recomputing(module: nn.Module):
    """Marks the forward of ``module`` that an activation checkpoint runs
    again inside the backward (``models/unet3d.py``'s ``remat``): each
    ``BatchNorm`` in it, in training, normalizes with the batch statistics
    again, collectives included, but leaves its running statistics and
    ``num_batches_tracked`` as the first forward advanced them."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def _normalize(x, mean, var, weight, bias, eps, dtype):
    y = (x.float() - mean) * (torch.rsqrt(var + eps) * weight.float())
    return (y + bias.float()).to(dtype)


class BatchNorm(nn.Module):
    """Batch norm over every axis but the last (flax ``nn.BatchNorm``
    semantics, momentum 0.9 on the running average, ε 1e-5); in training
    over the rows of every rank of ``stat_group`` (flax's ``axis_name``),
    so the running statistics stay the same on every rank."""

    def __init__(self, channels: int, policy: Policy = DEFAULT_POLICY,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.policy = policy
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=policy.param_dtype))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=policy.param_dtype))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        #: the process group whose ranks' rows make the batch (None: this
        #: rank's rows alone; ``core.mesh.set_stat_group``)
        self.stat_group = None
        #: set while an activation checkpoint runs this forward again
        #: (``recomputing``): the running statistics stay as they are
        self.recomputing = False

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.ndim - 1))
            xf = x.float()
            c = x.shape[-1]
            # the per-channel sums and the count in one collective over
            # ``stat_group`` (the global batch's statistics; the identity
            # without a group), differentiable like flax's psum
            count = torch.full((1,), float(x.numel() // c), device=x.device)
            stats = mesh.all_reduce_grad(torch.cat([xf.sum(axes), (xf * xf).sum(axes), count]),
                                         self.stat_group)
            mean = stats[:c] / stats[2 * c:]
            var = torch.clamp(stats[c:2 * c] / stats[2 * c:] - mean * mean, min=0.0)
            if self.recomputing:
                return _normalize(x, mean, var, self.weight, self.bias, self.eps,
                                  self.policy.compute_dtype)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return _normalize(x, mean, var, self.weight, self.bias, self.eps,
                          self.policy.compute_dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NDHWC (``groups == channels`` is instance
    norm), ε 1e-5."""

    def __init__(self, groups: int, channels: int, policy: Policy = DEFAULT_POLICY,
                 eps: float = 1e-5):
        super().__init__()
        if channels % groups:
            raise ValueError(f"{groups} groups do not divide {channels} channels")
        self.groups = groups
        self.policy = policy
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=policy.param_dtype))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=policy.param_dtype))

    def forward(self, x):
        c = x.shape[-1]
        xg = x.float().reshape(*x.shape[:-1], self.groups, c // self.groups)
        axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
        mean = xg.mean(axes, keepdim=True)
        var = torch.clamp((xg * xg).mean(axes, keepdim=True) - mean * mean, min=0.0)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (c,)
        mean = mean.expand(*mean.shape[:-1], c // self.groups).reshape(shape)
        var = var.expand(*var.shape[:-1], c // self.groups).reshape(shape)
        return _normalize(x, mean, var, self.weight, self.bias, self.eps,
                          self.policy.compute_dtype)


def make_norm(norm: str, channels: int, policy: Policy) -> nn.Module:
    """Norm menu of reference ``pcrlv2_model_3d.py:11-18``."""
    if norm == "bn":
        return BatchNorm(channels, policy)
    if norm == "gn":
        return GroupNorm(8, channels, policy)
    if norm == "in":
        return GroupNorm(channels, channels, policy)
    raise ValueError(f"normalization type {norm} is not supported")


class PReLU(nn.Module):
    """Per-channel PReLU, α initialized to 0.25."""

    def __init__(self, channels: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25,
                                              dtype=policy.param_dtype))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def make_act(act: str):
    """Parameter-free activations of reference ``pcrlv2_model_3d.py:20-30``
    (``prelu`` is the :class:`PReLU` module)."""
    acts = {"relu": torch.relu, "elu": torch.nn.functional.elu,
            "sigmoid": torch.sigmoid}
    if act not in acts:
        raise ValueError(f"activation type {act} is not supported")
    return acts[act]


class Conv3d(nn.Module):
    """``nn.Conv3d`` (k=3 padding 1, or k=1) over NDHWC via ``ops.conv3d``;
    torch default init U(±√(1/fan_in)) for weight and bias."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 policy: Policy, gen: torch.Generator):
        super().__init__()
        self.policy = policy
        fan_in = cin * kernel_size ** 3
        bound = math.sqrt(1.0 / fan_in)
        self.weight = _uniform((features, cin) + (kernel_size,) * 3, bound, gen)
        self.bias = _uniform((features,), bound, gen)

    def forward(self, x):
        return conv3d(self.policy.cast_to_compute(x), self.weight, self.bias)


class Conv2d(nn.Module):
    """``nn.Conv2d(k, stride, padding=k//2)`` over NHWC via ``ops.conv2d``;
    weight drawn by ``CONV2D_INITS[init]``, bias (``bias=True``) zero."""

    def __init__(self, cin: int, features: int, kernel_size: int, policy: Policy,
                 gen: torch.Generator, *, init: str, stride: int = 1, bias: bool = False):
        super().__init__()
        self.policy = policy
        self.stride = stride
        self.weight = CONV2D_INITS[init]((features, cin, kernel_size, kernel_size), gen)
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x):
        return conv2d(self.policy.cast_to_compute(x), self.weight, self.bias,
                      stride=self.stride)


class ConvTranspose3d(nn.Module):
    """``nn.ConvTranspose3d(k=2, stride=2)`` over NDHWC; init
    U(±√(1/(Co·k³))) for weight and bias."""

    def __init__(self, cin: int, features: int, policy: Policy,
                 gen: torch.Generator, kernel_size: int = 2):
        super().__init__()
        self.policy = policy
        bound = math.sqrt(1.0 / (features * kernel_size ** 3))
        self.weight = _uniform((cin, features) + (kernel_size,) * 3, bound, gen)
        self.bias = _uniform((features,), bound, gen)

    def forward(self, x):
        return conv_transpose3d(self.policy.cast_to_compute(x), self.weight,
                                self.bias, stride=self.weight.shape[-1])


class Dense(nn.Module):
    """``nn.Linear``; the product accumulates in f32 and the bias is added in
    f32 before the cast to the compute dtype.  Torch's init, or with
    ``xavier`` the 2D decoder's (xavier-uniform weight, zero bias)."""

    def __init__(self, cin: int, features: int, policy: Policy,
                 gen: torch.Generator, xavier: bool = False):
        super().__init__()
        self.policy = policy
        if xavier:
            self.weight = _xavier((features, cin), gen)
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            bound = math.sqrt(1.0 / cin)
            self.weight = _uniform((features, cin), bound, gen)
            self.bias = _uniform((features,), bound, gen)

    def forward(self, x):
        x = self.policy.cast_to_compute(x)
        out = x.float() @ self.weight.to(x.dtype).float().t() + self.bias.float()
        return out.to(x.dtype)


class MLPHead(nn.Module):
    """Predictor head Linear(c→2c) → BN1d → ReLU → Linear(2c→c); children
    named ``0``, ``1``, ``3`` as in the reference ``nn.Sequential``.
    ``decoder_init``: the 2D decoder's xavier Linears (reference
    ``pcrlv2_model.py:23-38``)."""

    def __init__(self, channels: int, policy: Policy, gen: torch.Generator,
                 decoder_init: bool = False):
        super().__init__()
        self.add_module("0", Dense(channels, 2 * channels, policy, gen, decoder_init))
        self.add_module("1", BatchNorm(2 * channels, policy))
        self.add_module("3", Dense(2 * channels, channels, policy, gen, decoder_init))

    def forward(self, x):
        x = self._modules["1"](self._modules["0"](x))
        return self._modules["3"](torch.relu(x))
