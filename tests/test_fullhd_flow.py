"""Full-HD dense-flow quality gate (VERDICT r2 item 1).

Renders the castle at 1920x1080 and gates the PRODUCTION path — estimated
flow (not GT flow) through occlusion masking into motion estimation — on
both a clean pair and a photometrically-corrupted pair (exposure gain +
vignette + sensor noise, the real-camera effects the reference's DeepFlow
path faces).  Thresholds carry ~50% margin over measured values
(STRESS.md; results/flow_variants.json).

Runs in f32 on the CPU (the XLA SOR loop); chip_smoke.py holds the same
gates on the GPU, where the fused SOR kernel runs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rs_sfm_tpu.config import PRODUCTION_CONFIG, PipelineConfig
from rs_sfm_tpu.data.synthetic import (apply_photometric, castle_scene,
                                       default_intrinsics, render_pair)
from rs_sfm_tpu.eval.metrics import translation_error
from rs_sfm_tpu.flow.dense import flow_forward_backward
from rs_sfm_tpu.flow.true_flow import true_flow
from rs_sfm_tpu.models import get_flow_preset
from rs_sfm_tpu.solver.pipeline import estimate_with_feedback

H, W = 1080, 1920
GAMMA = 0.9
V_TRUE = np.array([0.35, -0.15, 0.25])
W_TRUE = np.array([0.003, -0.002, 0.004])

# THE production estimation config (rs_sfm_tpu.config).  refine_winnow_iters
# =8: 4 batched starts for 8 LM iterations, then the vote winner alone
# (validated equivalent to the full 4x30 schedule at these gates).  The
# model-feedback passes are in the gated config: tight-consensus +
# depth-coherence outliers extend the untrusted mask and a warm-start
# Huber-LM re-estimation runs on the survivors.  feedback_passes=2: the
# iterated mask peel converges (mover scene 0.169 -> 0.121 -> 0.078
# across 1/2/3 passes on the protocol pair; photo 0.115 -> 0.105 on the
# HARDER f32 test render, 0.077 on the protocol pair).
# feedback_refine_iterations=8: the warm-start re-estimations only absorb
# the trusted-mask delta (50-eval protocol rows IDENTICAL on every scene).
# The basin re-vote and decimated inpainting were measured negative and
# stay off (config.py notes).
EST_CFG = PRODUCTION_CONFIG


@pytest.fixture(scope="module")
def fullhd_pair():
    intr = default_intrinsics(H, W)
    pair = render_pair(castle_scene(dtype=jnp.float32), intr, H, W,
                       gamma=GAMMA, k=0.0, v=V_TRUE, w=W_TRUE,
                       dtype=jnp.float32)
    gt = np.asarray(true_flow(pair.frame1.rs_unproject,
                              pair.frame2.poses_r, pair.frame2.poses_t,
                              intr))
    i1 = jnp.asarray(pair.frame1.rs_image, jnp.float32)
    i2 = jnp.asarray(pair.frame2.rs_image, jnp.float32)
    from rs_sfm_tpu.data.dataset import true_depth_from_unprojection

    td = jnp.asarray(true_depth_from_unprojection(
        np.asarray(pair.frame1.rs_unproject),
        np.asarray(pair.frame1.poses_r),
        np.asarray(pair.frame1.poses_t)), jnp.float32)
    return (intr, i1, i2, gt, td,
            jnp.asarray(pair.frame1.poses_r, jnp.float32),
            jnp.asarray(pair.frame1.poses_t, jnp.float32))


def _gate(pair_data, i2, preset, *, epe_med_max, err_v_max,
          err3d_max=None, depth_rmse_max=None):
    """Production-path gate: flow EPE + pose error + (r4) 3D/depth error.

    err3d is the reference's scale-aligned mean 3D reprojection error
    (src/errorMeasure.cpp:229, src/camera.cc:593-691); depth RMSE is the
    BASELINE north-star depth metric — both previously measured but
    ungated (VERDICT r3 missing #2)."""
    intr, i1, _, gt, td, poses_r, poses_t = pair_data
    cfg = get_flow_preset(preset)
    fb = flow_forward_backward(i1, i2, cfg)
    f = np.asarray(fb.flow)
    moving = np.linalg.norm(gt, axis=-1) > 0
    epe = np.linalg.norm(f - gt, axis=-1)
    epe_med = float(np.median(epe[moving]))
    assert epe_med <= epe_med_max, (preset, epe_med)
    res = estimate_with_feedback(fb.flow, intr, GAMMA, EST_CFG,
                                 jax.random.PRNGKey(0),
                                 pixel_mask=~fb.occlusion)
    err_v = float(translation_error(res.v, jnp.asarray(V_TRUE, jnp.float32)))
    assert err_v <= err_v_max, (preset, err_v)
    if err3d_max is not None:
        from rs_sfm_tpu.eval.metrics import depth_rmse, \
            mean_reprojection_error
        from rs_sfm_tpu.geom.rspose import scanline_poses
        from rs_sfm_tpu.rectify.backproject import backproject

        r_sl, t_sl = scanline_poses(res.v, res.w, res.k, H, GAMMA,
                                    dtype=jnp.float32)
        rect = backproject(i1, res.depth_map, r_sl, t_sl, intr)
        err3d, _, _ = mean_reprojection_error(
            rect.coords_3d, rect.valid, td, poses_r, poses_t, intr)
        assert float(err3d) <= err3d_max, (preset, float(err3d))
        drmse, _ = depth_rmse(res.depth_map, td, res.inlier_mask)
        assert float(drmse) <= depth_rmse_max, (preset, float(drmse))
    return epe_med, err_v


def test_fullhd_clean_plain(fullhd_pair):
    """Clean full-HD: median EPE sub-pixel-ish, err_v well under the
    gate (r4 protocol: 0.079 px / 0.0200 rad with the Huber-IRLS
    refinement); err3d gated at 0.35 (protocol mean 0.149 — tighter than
    the VERDICT bar of 0.5) and depth RMSE at 0.9 (protocol 0.49)."""
    _gate(fullhd_pair, fullhd_pair[2], "variational",
          epe_med_max=0.3, err_v_max=0.04,
          err3d_max=0.35, depth_rmse_max=0.9)


def test_fullhd_photometric_robust(fullhd_pair):
    """Exposure x1.35 + vignette 0.35 + noise: the robust (LCN) preset
    with the r5 production config (coarse warps + 2 model-feedback
    passes): 1.76 px median; err_v 0.105 on THIS render (0.077 on the
    f64 protocol pair — the VERDICT item-2 protocol bar) — the err_v
    gate moves 0.15 -> 0.12."""
    intr, i1, i2 = fullhd_pair[0], fullhd_pair[1], fullhd_pair[2]
    i2p = jnp.asarray(apply_photometric(
        i2, jax.random.PRNGKey(1), exposure=1.35, vignette=0.35,
        noise_sigma=0.005), jnp.float32)
    _gate(fullhd_pair, i2p, "robust",
          epe_med_max=3.5, err_v_max=0.12,
          err3d_max=1.0, depth_rmse_max=2.2)


def test_auto_preset_selection(fullhd_pair):
    """`--flow-model auto` (VERDICT r4 item 4): the coarse probe must pick
    plain on the clean pair (keeping the 0.040 rad accuracy) and robust on
    the photometric pair — selection correctness plus the two preset gates
    above imply all protocol rows pass with no per-scene flags."""
    from rs_sfm_tpu.flow.auto import probe_flow_preset

    intr, i1, i2 = fullhd_pair[0], fullhd_pair[1], fullhd_pair[2]
    name, stats = probe_flow_preset(i1, i2, return_stats=True)
    assert name == "variational", (name, stats)
    i2p = jnp.asarray(apply_photometric(
        i2, jax.random.PRNGKey(1), exposure=1.35, vignette=0.35,
        noise_sigma=0.005), jnp.float32)
    name_p, stats_p = probe_flow_preset(i1, i2p, return_stats=True)
    assert name_p == "robust", (name_p, stats_p)


def test_fullhd_stress_movers_and_seed_stability():
    """r5 (VERDICT r4 item 3): the mover/occluder scene is CI-gated, plus
    a seed-stability assertion so the two selection-precision bug classes
    fixed in r4 (f32 composite-score ties; winnow selection) can never
    silently return.

    Production config on the test render measured 0.143/0.145 (fbp=1) —
    the 2 production seeds gate at 0.16; the 8-seed stability check runs
    a REDUCED config (10 iters, winnow 4, no feedback — the RANSAC/
    selection machinery the gate protects, at CI-affordable cost):
    measured med 0.234, p90/med 1.05 — gated at 1.3 (the r4 bug
    symptom was mean/median spreads of 1.5-2.4x)."""
    from rs_sfm_tpu.data.synthetic import stress_scene

    intr = default_intrinsics(H, W)
    pair = render_pair(stress_scene(dtype=jnp.float32), intr, H, W,
                       gamma=GAMMA, k=0.0, v=V_TRUE, w=W_TRUE,
                       dtype=jnp.float32)
    i1 = jnp.asarray(pair.frame1.rs_image, jnp.float32)
    i2 = jnp.asarray(pair.frame2.rs_image, jnp.float32)
    fb = flow_forward_backward(i1, i2, get_flow_preset("variational"))

    for seed in range(2):
        res = estimate_with_feedback(fb.flow, intr, GAMMA, EST_CFG,
                                     jax.random.PRNGKey(seed),
                                     pixel_mask=~fb.occlusion)
        err_v = float(translation_error(res.v,
                                        jnp.asarray(V_TRUE, jnp.float32)))
        assert err_v <= 0.16, (seed, err_v)

    reduced = PipelineConfig(ransac_trials=256, ransac_tol=0.02,
                             refine_iterations=10, refine_starts=4,
                             refine_winnow_iters=4, refine_rel_tol=0.0,
                             depth_residual_px=2.0,
                             refine_loss_delta_px=3.0)
    errs = []
    for seed in range(8):
        res = estimate_with_feedback(fb.flow, intr, GAMMA, reduced,
                                     jax.random.PRNGKey(200 + seed),
                                     pixel_mask=~fb.occlusion)
        errs.append(float(translation_error(
            res.v, jnp.asarray(V_TRUE, jnp.float32))))
    errs = np.asarray(errs)
    med = float(np.median(errs))
    p90 = float(np.percentile(errs, 90))
    assert med <= 0.30, errs.tolist()
    assert p90 / med <= 1.3, (med, p90, errs.tolist())
