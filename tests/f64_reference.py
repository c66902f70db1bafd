"""Float64 JAX references for the port's tests, traced with their
convolutions as products.

XLA's CPU backend runs f16 and f32 convolutions through Eigen, but float64
ones through a plain loop nest: 10-40× the f32 time at the test sizes, and
about nine tenths of a float64 gradient run of the JAX models.  Inside
``convs_as_products()`` each channels-last float64
``lax.conv_general_dilated`` (no dilation, no groups: every conv the JAX
models trace) is traced as im2col instead: one gather of the padded input's
windows, one product with the flattened kernel, and for the gradient their
transposes (a scatter-add and products).  It is the same sum in another
order, so the float64 results move by ~1e-14 of their scale (measured on
the 3D pretask gradient), far below any tolerance the tests hold the f32
port to.  Every other conv (f32, grouped, dilated) is XLA's as before.

The patch holds only while a function is traced: wrap the jitted function's
calls in ``convs_as_products()``, or use ``traced_with_convs_as_products``.

The compile options below trade XLA's CPU backend optimisation (LLVM
``-O2`` by default) for compile time, where compiling a reference takes
most of its time: ``INIT_COMPILE`` (``-O1``) for the 3D model's
initialisation (8.9 → 3.5 s to compile, the same parameters bit for bit),
``ONCE_COMPILE`` (``-O0``) for the float64 2D references that run once
(the 2D gradient's compile 16.0 → 11.5 s, its run 0.5 → 1.0 s).  ``-O0``
moves float64 results in their last bits only.  f32 programs keep the
default, which these options move by up to 2e-4 relative; so do the 3D
float64 programs, whose run ``-O0`` slows by more than it saves.
"""

import contextlib
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

#: ``jax.jit(..., compiler_options=...)`` (module doc): LLVM at -O1, and at -O0
INIT_COMPILE = {"xla_backend_optimization_level": 1}
ONCE_COMPILE = {"xla_backend_optimization_level": 0}

_CHANNELS_LAST = {("NDHWC", "DHWIO", "NDHWC"), ("NHWC", "HWIO", "NHWC")}


def _window_index(spatial, kernel, strides):
    """(out positions, taps) indices into the flattened padded input."""
    out = [(n - k) // s + 1 for n, k, s in zip(spatial, kernel, strides)]
    starts = np.meshgrid(*[np.arange(o) * s for o, s in zip(out, strides)], indexing="ij")
    taps = np.meshgrid(*[np.arange(k) for k in kernel], indexing="ij")
    index = sum((a.reshape(-1, 1) + t.reshape(1, -1)) * int(np.prod(spatial[i + 1:]))
                for i, (a, t) in enumerate(zip(starts, taps)))
    return out, index.reshape(-1)


def _conv_as_product(conv, lhs, rhs, window_strides, padding, lhs_dilation=None,
                     rhs_dilation=None, dimension_numbers=None, feature_group_count=1,
                     batch_group_count=1, **kwargs):
    plain = (lhs.dtype != jnp.float64 or tuple(dimension_numbers or ()) not in _CHANNELS_LAST
             or feature_group_count != 1 or batch_group_count != 1
             or any(d != 1 for d in (lhs_dilation or ()))
             or any(d != 1 for d in (rhs_dilation or ())))
    if plain:
        return conv(lhs, rhs, window_strides, padding, lhs_dilation, rhs_dilation,
                    dimension_numbers, feature_group_count, batch_group_count, **kwargs)
    kernel = rhs.shape[:-2]
    if isinstance(padding, str):
        padding = lax.padtype_to_pads(lhs.shape[1:-1], kernel, window_strides, padding)
    x = jnp.pad(lhs, [(0, 0)] + [tuple(p) for p in padding] + [(0, 0)])
    out, index = _window_index(x.shape[1:-1], kernel, window_strides)
    cols = x.reshape(x.shape[0], -1, x.shape[-1])[:, index, :]
    cols = cols.reshape((x.shape[0], *out, -1))
    return lax.dot_general(cols, rhs.reshape(-1, rhs.shape[-1]).astype(cols.dtype),
                           (((cols.ndim - 1,), (0,)), ((), ())),
                           precision=lax.Precision.HIGHEST)


@contextlib.contextmanager
def convs_as_products():
    """Trace float64 channels-last convs as im2col products (module doc)."""
    conv = lax.conv_general_dilated
    lax.conv_general_dilated = functools.partial(_conv_as_product, conv)
    try:
        yield
    finally:
        lax.conv_general_dilated = conv


def traced_with_convs_as_products(fn):
    """``fn`` (jitted) with every call, so every trace, under the patch."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with convs_as_products():
            return fn(*args, **kwargs)
    return call
