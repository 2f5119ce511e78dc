"""Sharded estimation on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from rs_sfm_tpu.config import PipelineConfig
from rs_sfm_tpu.data.synthetic import (castle_scene, default_intrinsics,
                                       render_pair)
from rs_sfm_tpu.flow.true_flow import true_flow
from rs_sfm_tpu.parallel.api import estimate_pairs_batched, estimate_sharded
from rs_sfm_tpu.parallel.mesh import make_mesh
from rs_sfm_tpu.solver.pipeline import estimate_from_flow

H = W = 64
GAMMA = 0.9
V_TRUE = np.array([0.12, -0.05, 0.08])
W_TRUE = np.array([0.003, -0.002, 0.004])


def _flow(dtype=jnp.float64):
    scene = castle_scene(dtype=dtype)
    intr = default_intrinsics(H, W)
    pair = render_pair(scene, intr, H, W, gamma=GAMMA, k=0.0,
                       v=V_TRUE, w=W_TRUE, dtype=dtype)
    return true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                     pair.frame2.poses_t, intr), intr


def _check(v_est, w_est):
    v_unit = V_TRUE / np.linalg.norm(V_TRUE)
    vang = np.arccos(np.clip(
        np.asarray(v_est) @ v_unit / np.linalg.norm(v_est), -1, 1))
    assert vang < 0.05, vang
    assert np.linalg.norm(np.asarray(w_est) - W_TRUE) < 2e-3


def test_mesh_shapes():
    mesh = make_mesh(pairs=2)
    assert mesh.shape == {"pairs": 2, "pixels": 4}


def test_batched_pairs_sharded():
    flow, intr = _flow()
    cfg = PipelineConfig(ransac_trials=32, ransac_tol=0.01,
                         refine_iterations=20)
    mesh = make_mesh(pairs=2, pixels=4)
    run = estimate_pairs_batched(mesh, intr, GAMMA, cfg)
    batch = jnp.stack([flow, flow])
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    res = run(batch, keys)
    for b in range(2):
        _check(res.v[b], res.w[b])
    # Both pairs identical input+distinct keys -> consistent estimates.
    assert np.allclose(res.depth_map[0].sum(), res.depth_map[1].sum(),
                       rtol=0.2)


def test_shard_map_matches_single_device():
    flow, intr = _flow()
    cfg = PipelineConfig(ransac_trials=32, ransac_tol=0.01,
                         refine_iterations=30)
    mesh = make_mesh(pairs=1, pixels=8)
    run = estimate_sharded(mesh, intr, GAMMA, cfg, pool_per_shard=256)
    res = run(flow, jax.random.PRNGKey(0))
    v, w, num = res.v, res.w, res.num_inliers
    _check(v, w)
    assert int(num) > 0.5 * H * W
    # Single-device reference on the same flow.
    ref = estimate_from_flow(flow, intr, GAMMA, cfg, jax.random.PRNGKey(0))
    # Different sampling pools => not bitwise equal, and the refinement has
    # a free scale gauge on (v, rho); compare directions and w.
    v1 = np.asarray(v) / np.linalg.norm(v)
    v2 = np.asarray(ref.v) / np.linalg.norm(ref.v)
    assert np.arccos(np.clip(abs(v1 @ v2), -1, 1)) < 2e-3
    assert np.linalg.norm(np.asarray(w) - np.asarray(ref.w)) < 1e-4


def test_sharded_full_features():
    """The de-forked sharded path runs the FULL pipeline feature set —
    acceleration model (k-scan), two-stage prescore, multi-start
    refinement — through the same estimate_from_flow code path."""
    flow, intr = _flow()
    cfg = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                         refine_iterations=20, refine_starts=2,
                         use_acceleration=True, k_scan_points=9,
                         ransac_prescore_subsample=256,
                         ransac_prescore_keep=8)
    mesh = make_mesh(pairs=1, pixels=8)
    run = estimate_sharded(mesh, intr, GAMMA, cfg, pool_per_shard=256)
    res = run(flow, jax.random.PRNGKey(3))
    _check(res.v, res.w)
    assert abs(float(res.k)) < 0.3  # true k = 0
    assert int(res.num_inliers) > 0.5 * H * W


def test_sharded_collective_count_o1_in_trials():
    """O(1) collectives per RANSAC: the compiled all-reduce count must not
    grow with the number of hypotheses (votes reduce as ONE stacked table,
    never per hypothesis)."""
    flow, intr = _flow(dtype=jnp.float32)
    mesh = make_mesh(pairs=1, pixels=8)
    counts = []
    for trials in (16, 64):
        cfg = PipelineConfig(ransac_trials=trials, ransac_tol=0.01,
                             refine_iterations=5)
        run = estimate_sharded(mesh, intr, GAMMA, cfg, pool_per_shard=128)
        txt = (jax.jit(run)
               .lower(flow, jax.random.PRNGKey(0))
               .compile().as_text())
        counts.append(txt.count("all-reduce"))
    assert counts[0] == counts[1], counts
