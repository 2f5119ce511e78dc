"""Pyramid resampling primitives as convolutions.

The flow pyramid's formulations — `blur(x)[::2, ::2]` for downsampling
and a stack/reshape interleave for the exact 2x bilinear upsample
(flow/dense.py `_downsample`/`_up2`) — decimate and interleave the last
dimension.  The formulations here express the same stencils as strided /
dilated convolutions (`lax.conv_general_dilated`) instead, for a backend
whose compiler relays out such planes.  Not on the production path; not
measured on a GPU (ROADMAP D2):

  * down2_blur(x)  == _gauss_blur(x)[::2, ::2]   (5-tap binomial,
    edge-clamped via explicit edge padding + VALID windows);
  * up2(x)         == _up2(x)                    (half-pixel-center exact
    2x bilinear: kernel [0.25, 0.75, 0.75, 0.25], lhs_dilation=2).

Both match the originals to float reassociation (<= 1e-6 relative; the
conv may sum taps in a different order).  Exactness tests:
tests/test_resample.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_DN = ("NHWC", "HWIO", "NHWC")


def _conv(x4, kern, strides, lhs_dilation=(1, 1)):
    # Explicit zero padding: "VALID" is rejected for lhs-dilated
    # (transposed) convolutions.
    return lax.conv_general_dilated(
        x4, kern, window_strides=strides, padding=((0, 0), (0, 0)),
        lhs_dilation=lhs_dilation, dimension_numbers=_DN)


def down2_blur(x):
    """5-tap binomial blur + 2x decimation in one strided conv pair.

    Equals flow/dense.py `_downsample` (edge-replicated boundaries,
    output sample i at blurred input row/col 2i) to float reassociation.
    Accepts (H, W) or (..., H, W); output (..., ceil(H/2), ceil(W/2)).
    """
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    k = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], x.dtype) / 16.0
    xp = jnp.pad(x.reshape((-1,) + x.shape[-2:]),
                 ((0, 0), (2, 2), (2, 2)), mode="edge")[..., None]
    y = _conv(xp, k.reshape(5, 1, 1, 1), (2, 1))
    y = _conv(y, k.reshape(1, 5, 1, 1), (1, 2))
    return y[..., 0].reshape(lead + y.shape[1:3])


def up2(x):
    """Exact 2x bilinear upsample (half-pixel-center convention).

    Equals flow/dense.py `_up2` — out[2i] = 0.75 x[i] + 0.25 x[i-1],
    out[2i+1] = 0.75 x[i] + 0.25 x[i+1], edge-clamped — expressed as a
    transposed (input-dilated) conv with kernel [1, 3, 3, 1]/4.
    Accepts (H, W) or (..., H, W); output (..., 2H, 2W).
    """
    lead = x.shape[:-2]
    k = jnp.asarray([0.25, 0.75, 0.75, 0.25], x.dtype)
    xp = jnp.pad(x.reshape((-1,) + x.shape[-2:]),
                 ((0, 0), (1, 1), (1, 1)), mode="edge")[..., None]
    y = _conv(xp, k.reshape(4, 1, 1, 1), (1, 1), lhs_dilation=(2, 1))
    y = _conv(y, k.reshape(1, 4, 1, 1), (1, 1), lhs_dilation=(1, 2))
    return y[..., 0].reshape(lead + y.shape[1:3])
