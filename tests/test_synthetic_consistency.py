"""The load-bearing geometry checks: the synthetic renderer, the analytic
flow model, and the estimation pipeline must all agree.

This is the analog of the reference's ground-truth-instrumented
synthetic harness (SURVEY.md §4): the renderer produces exact geometry, the
differential flow model is a first-order approximation of it, and the solver
chain must recover the generating motion from the exact flow.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rs_sfm_tpu.config import PipelineConfig
from rs_sfm_tpu.data.synthetic import (castle_scene, default_intrinsics,
                                       render_pair)
from rs_sfm_tpu.flow.true_flow import true_flow
from rs_sfm_tpu.solver.flow_model import predict_flow
from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu.solver.pipeline import estimate_from_flow
from rs_sfm_tpu.geom.camera import normalize_coords, pixel_grid

H = W = 96
GAMMA = 0.9
V_TRUE = np.array([0.12, -0.05, 0.08])
W_TRUE = np.array([0.003, -0.002, 0.004])


def _pair(k=0.0, v=V_TRUE, w=W_TRUE, dtype=jnp.float64):
    scene = castle_scene(dtype=dtype)
    intr = default_intrinsics(H, W)
    return render_pair(scene, intr, H, W, gamma=GAMMA, k=k,
                       v=v, w=w, dtype=dtype), intr


def test_renderer_basics():
    pair, intr = _pair()
    f1 = pair.frame1
    img = np.asarray(f1.rs_image)
    assert img.shape == (H, W, 3)
    hit = np.asarray(f1.rs_depth) > 0
    # Scene should cover most of the image but leave some sky.
    assert 0.5 < hit.mean() <= 1.0
    # Unprojection maps must reproject to their own pixel under the row pose.
    r = np.asarray(f1.poses_r)
    t = np.asarray(f1.poses_t)
    un = np.asarray(f1.rs_unproject)
    ys, xs = np.mgrid[0:H, 0:W]
    for (y, x) in [(10, 20), (50, 50), (80, 12), (33, 70)]:
        if not hit[y, x]:
            continue
        cam = r[y] @ un[y, x] + t[y]
        px = cam[:2] / cam[2] * intr.fx + np.array([intr.cx, intr.cy])
        np.testing.assert_allclose(px, [x, y], atol=1e-3)
        np.testing.assert_allclose(cam[2], np.asarray(f1.rs_depth)[y, x],
                                   rtol=1e-6)


def test_true_flow_matches_differential_model():
    """GT reprojection flow ≈ β(A·v·ρ + B·w) at ground truth — the identity
    the whole method rests on (report eq. 5-12)."""
    pair, intr = _pair()
    f1, f2 = pair.frame1, pair.frame2
    flow_px = np.asarray(true_flow(f1.rs_unproject, f2.poses_r, f2.poses_t,
                                   intr))
    hit = np.asarray(f1.rs_depth) > 0
    # Model prediction in pixel units.
    grid = pixel_grid(H, W, dtype=jnp.float64)
    coords = normalize_coords(grid, intr)
    rho = jnp.where(pair.frame1.rs_depth > 0, 1.0 / pair.frame1.rs_depth, 0.0)
    alpha = get_alpha(jnp.asarray(flow_px[..., 1]), H, GAMMA)
    alpha_k = get_alpha_k(grid[..., 1], jnp.asarray(flow_px[..., 1]), H, GAMMA)
    u_model = predict_flow(coords, rho, pair.v, pair.w, 0.0, alpha, alpha_k)
    model_px = np.asarray(u_model) * intr.fx

    err = np.linalg.norm(model_px - flow_px, axis=-1)
    mag = np.linalg.norm(flow_px, axis=-1)
    interior = hit & (mag > 1e-6)
    # Differential model is first order; tolerance scales with flow size.
    assert mag[interior].mean() > 0.5, "flow should be non-trivial"
    assert np.quantile(err[interior], 0.9) < 0.05 * max(1.0, mag[interior].mean())


@pytest.mark.parametrize("use_refinement", [False, True])
def test_pipeline_recovers_motion(use_refinement):
    pair, intr = _pair()
    f1, f2 = pair.frame1, pair.frame2
    flow_px = true_flow(f1.rs_unproject, f2.poses_r, f2.poses_t, intr)
    cfg = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                         use_refinement=use_refinement)
    res = estimate_from_flow(flow_px, intr, GAMMA, cfg,
                             jax.random.PRNGKey(0))
    v_est = np.asarray(res.v)
    w_est = np.asarray(res.w)
    v_unit = V_TRUE / np.linalg.norm(V_TRUE)
    # Sign-disambiguated direction match.
    vang = np.arccos(np.clip(v_est @ v_unit / np.linalg.norm(v_est), -1, 1))
    assert vang < 0.03, f"translation direction error {vang}"
    assert np.linalg.norm(w_est - W_TRUE) < 2e-3
    assert int(res.num_inliers) > 0.5 * H * W
    # Depth parity up to global scale on the inlier set.
    d_est = np.asarray(res.depth_map)
    d_true = np.asarray(f1.rs_depth)
    m = (d_est != 0) & (d_true > 0)
    scale = np.median(d_est[m] / d_true[m])
    rel = np.abs(d_est[m] / scale - d_true[m]) / d_true[m]
    assert np.median(rel) < 0.05


def test_pipeline_recovers_k():
    k_true = 0.8
    pair, intr = _pair(k=k_true)
    f1, f2 = pair.frame1, pair.frame2
    flow_px = true_flow(f1.rs_unproject, f2.poses_r, f2.poses_t, intr)
    cfg = PipelineConfig(ransac_trials=64, ransac_tol=0.005,
                         use_acceleration=True, use_refinement=True)
    res = estimate_from_flow(flow_px, intr, GAMMA, cfg, jax.random.PRNGKey(1))
    assert abs(float(res.k) - k_true) < 0.2, float(res.k)
    v_est = np.asarray(res.v)
    v_unit = V_TRUE / np.linalg.norm(V_TRUE)
    vang = np.arccos(np.clip(v_est @ v_unit / np.linalg.norm(v_est), -1, 1))
    assert vang < 0.05


def test_gs_limit():
    """γ→0 collapses to the global-shutter model: α→1 and the GS pipeline
    should match the RS pipeline (report §3.3.2 property)."""
    scene = castle_scene(dtype=jnp.float64)
    intr = default_intrinsics(H, W)
    pair = render_pair(scene, intr, H, W, gamma=1e-9, k=0.0,
                       v=V_TRUE, w=W_TRUE, dtype=jnp.float64)
    flow_px = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                        pair.frame2.poses_t, intr)
    cfg = PipelineConfig(ransac_trials=32, ransac_tol=0.01,
                         use_global_shutter=True, use_refinement=False)
    # gamma enters flow normalization; use a tiny but nonzero value.
    res = estimate_from_flow(flow_px, intr, 1e-9, cfg, jax.random.PRNGKey(2))
    # With γ≈0 both frames' scanlines share one pose each; flow is then pure
    # GS flow and normalized flow ∝ γ — direction recovery must still work.
    v_est = np.asarray(res.v)
    v_unit = V_TRUE / np.linalg.norm(V_TRUE)
    vang = np.arccos(np.clip(abs(v_est @ v_unit) / np.linalg.norm(v_est), -1, 1))
    assert vang < 0.05


def test_prescore_matches_full_scoring():
    """Two-stage RANSAC picks an equivalent winner on clean data."""
    pair, intr = _pair()
    f1, f2 = pair.frame1, pair.frame2
    flow_px = true_flow(f1.rs_unproject, f2.poses_r, f2.poses_t, intr)
    full = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                          use_refinement=False)
    fast = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                          use_refinement=False,
                          ransac_prescore_subsample=1024,
                          ransac_prescore_keep=8)
    a = estimate_from_flow(flow_px, intr, GAMMA, full, jax.random.PRNGKey(3))
    b = estimate_from_flow(flow_px, intr, GAMMA, fast, jax.random.PRNGKey(3))
    va = np.asarray(a.v) / np.linalg.norm(a.v)
    vb = np.asarray(b.v) / np.linalg.norm(b.v)
    assert np.arccos(np.clip(abs(va @ vb), -1, 1)) < 5e-3
    assert abs(int(a.num_inliers) - int(b.num_inliers)) < 0.05 * H * W
