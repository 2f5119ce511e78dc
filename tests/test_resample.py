"""Conv-based pyramid resampling (ops/resample.py) vs the original
shift/interleave formulations (flow/dense.py) — same stencils, lowered as
convolutions (see the module docstring)."""

import numpy as np
import pytest

import jax.numpy as jnp

from rs_sfm_tpu.flow import dense as D
from rs_sfm_tpu.ops.resample import down2_blur, up2


@pytest.mark.parametrize("shape", [(64, 128), (63, 127), (33, 60),
                                   (24, 64)])
def test_down2_matches_blur_slice(shape):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, shape), jnp.float32)
    ref = D._gauss_blur(x)[::2, ::2]
    got = down2_blur(x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape", [(64, 128), (63, 127), (17, 33)])
def test_up2_matches_interleave(shape):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(-1, 1, shape), jnp.float32)
    ref = D._up2(x)
    got = up2(x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=2e-6)


def test_down2_batched_leading_axes():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.uniform(-1, 1, (3, 40, 64)), jnp.float32)
    got = down2_blur(x)
    assert got.shape == (3, 20, 32)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(got[i]),
            np.asarray(D._gauss_blur(x[i])[::2, ::2]), rtol=0, atol=2e-6)


def test_up2_batched_leading_axes():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-1, 1, (2, 20, 32)), jnp.float32)
    got = up2(x)
    assert got.shape == (2, 40, 64)
    for i in range(2):
        np.testing.assert_allclose(np.asarray(got[i]),
                                   np.asarray(D._up2(x[i])),
                                   rtol=0, atol=2e-6)
