"""The fused SOR kernel (ops/sor_cuda.py, native/sor_cuda.cu).

The kernel's tile/halo schedule is replayed in jax.numpy
(sor_sweeps_tiled) and checked against the global XLA loop on odd shapes
and partial schedules — the exactness argument the kernel rests on.  The
kernel itself runs only on the card: its comparison test is marked `gpu`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rs_sfm_tpu.flow.dense import (DenseFlowConfig, _linearise,
                                   _use_sor_kernel, _warp, sor_sweeps_xla)
from rs_sfm_tpu.ops import sor_cuda


def _linear_problem(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.9, (h + 8, w + 8)).astype(np.float32)
    for _ in range(2):
        for ax in (0, 1):
            base = (np.roll(base, 1, ax) + 2 * base
                    + np.roll(base, -1, ax)) / 4.0
    i1 = jnp.asarray(base[4:4 + h, 4:4 + w])
    i2 = jnp.asarray(base[2:2 + h, 6:6 + w])
    flow = jnp.asarray(rng.normal(scale=0.5, size=(h, w, 2)), jnp.float32)
    return _linearise(i1, _warp(i2, flow), flow)


@pytest.mark.parametrize("h, w, iters, tile", [
    (70, 150, 20, (32, 64, 4)),    # the kernel's tiles, full launches
    (45, 97, 13, (8, 16, 4)),      # odd shape, partial last launch
    (33, 50, 7, (8, 16, 3)),       # 3-sweep launches, remainder 1
    (16, 16, 5, (32, 64, 4)),      # image smaller than one tile
])
def test_tiled_schedule_matches_xla_loop(h, w, iters, tile):
    lin = _linear_problem(h, w, seed=h)
    cfg = DenseFlowConfig()
    ref = jax.jit(lambda t: sor_sweeps_xla(t, iters, cfg))(lin)
    got = jax.jit(lambda t: sor_cuda.sor_sweeps_tiled(
        t, iters, cfg, tile_y=tile[0], tile_x=tile[1],
        tile_sweeps=tile[2]))(lin)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5)
    # The sweeps did real work.
    assert float(jnp.abs(ref[0] - lin.u0).max()) > 0.1


def test_kernel_selection():
    cfg = DenseFlowConfig()
    on_gpu = jax.default_backend() == "gpu"
    assert _use_sor_kernel(cfg, masked=False) == on_gpu
    assert not _use_sor_kernel(cfg._replace(sor_engine="xla"), False)
    assert not _use_sor_kernel(cfg._replace(census_weight=1.0), False)
    assert not _use_sor_kernel(cfg, masked=True)
    with pytest.raises(ValueError):
        _use_sor_kernel(cfg._replace(sor_engine="pallas"), False)


def test_kernel_raises_off_gpu():
    if jax.default_backend() == "gpu":
        pytest.skip("on a GPU the kernel runs (see the gpu-marked test)")
    with pytest.raises(RuntimeError, match="only on a GPU"):
        sor_cuda.sor_sweeps(_linear_problem(16, 16), 4, DenseFlowConfig())


@pytest.mark.gpu
@pytest.mark.parametrize("h, w", [(1080, 1920), (135, 240), (17, 30)])
def test_kernel_matches_xla_loop_on_gpu(h, w):
    if jax.default_backend() != "gpu":
        pytest.skip("the CUDA kernel has no CPU path; runs on the card")
    lin = _linear_problem(h, w, seed=1)
    cfg = DenseFlowConfig()
    ref = jax.jit(lambda t: sor_sweeps_xla(t, 20, cfg))(lin)
    got = jax.jit(lambda t: sor_cuda.sor_sweeps(t, 20, cfg))(lin)
    # The Charbonnier re-weighting turns one rounding of difference into
    # up to ~1e-3 px; a schedule fault moves tile borders by whole sweep
    # updates (chip_smoke.phase_sor gives the argument and the same bound).
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-2)
