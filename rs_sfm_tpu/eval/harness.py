"""Evaluation harness: the reference's evaluateVelocities protocol.

error_measure::evaluateVelocities (reference src/errorMeasure.cpp:41-254):
flow → flatten/normalize → N repeated evaluations of RANSAC(+refinement) →
per-run rotation/translation errors, depth map artifact, back-projection,
scale-aligned 3D reprojection error → averaged VelocityErrors.

Here each evaluation is one call of the jitted pipeline with a fresh PRNG
key (the reference's repetition loop exists because its RANSAC is
time-seeded and noisy; ours is deterministic per key).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from rs_sfm_tpu.config import PipelineConfig
from rs_sfm_tpu.data.dataset import PairData, true_depth_from_unprojection
from rs_sfm_tpu.eval import artifacts
from rs_sfm_tpu.eval.metrics import (depth_rmse, mean_reprojection_error,
                                     rotation_error, translation_error)
from rs_sfm_tpu.flow.true_flow import true_flow
from rs_sfm_tpu.geom.rspose import scanline_poses
from rs_sfm_tpu.rectify.backproject import backproject
from rs_sfm_tpu.solver.pipeline import estimate_with_feedback

import functools


@functools.partial(jax.jit,
                   static_argnames=("intr", "gamma", "cfg", "has_mask"))
def _estimate_jit(flow_px, intr, gamma, cfg, key, pixel_mask=None,
                  has_mask=False):
    """Jitted pipeline (intrinsics/config are hashable frozen dataclasses);
    compiled once per (shape, config) across evaluations and sweep tasks.
    Runs the model-feedback passes when cfg.feedback_passes > 0."""
    return estimate_with_feedback(flow_px, intr, gamma, cfg, key,
                                  pixel_mask=pixel_mask if has_mask
                                  else None)


class VelocityErrors(NamedTuple):
    """Per-run arrays + means (reference VelocityErrors,
    src/errorMeasure.h:18-44)."""

    w: np.ndarray               # (3, num_evaluations)
    v: np.ndarray               # (3, num_evaluations)
    k: np.ndarray               # (num_evaluations,)
    error_w_vec: np.ndarray     # (num_evaluations,)
    error_v_vec: np.ndarray     # (num_evaluations,)
    error_reproject_vec: np.ndarray  # (num_evaluations,)
    error_w: float
    error_v: float
    error_reproject: float
    num_inliers: np.ndarray     # (num_evaluations,)
    # r4 depth-quality columns (batched harness only; None on the
    # sequential path unless GT depth is available).
    error_reproject_ls_vec: np.ndarray = None  # LS gauge-scale err3d
    depth_rmse_vec: np.ndarray = None          # scale-aligned depth RMSE


def compute_flow(pair: PairData, use_deep_flow: bool = False,
                 dtype=jnp.float32, flow_cfg=None):
    """Dense flow for a pair: ground-truth reprojection flow or dense
    estimation (src/errorMeasure.cpp:48-55).

    flow_cfg: optional DenseFlowConfig for the dense path (warp engine,
    census term, etc.).
    """
    if use_deep_flow:
        from rs_sfm_tpu.flow.dense import DenseFlowConfig, dense_flow

        def unit(img):
            arr = jnp.asarray(img, dtype=dtype)
            return arr / 255.0 if np.asarray(img).dtype == np.uint8 else arr

        return dense_flow(unit(pair.frame1.rs_image),
                          unit(pair.frame2.rs_image),
                          flow_cfg or DenseFlowConfig())
    if pair.frame1.rs_unproject is None:
        raise ValueError("ground-truth flow needs unprojection maps; "
                         "use use_deep_flow=True for real pairs")
    return true_flow(jnp.asarray(pair.frame1.rs_unproject, dtype=dtype),
                     jnp.asarray(pair.frame2.poses_r, dtype=dtype),
                     jnp.asarray(pair.frame2.poses_t, dtype=dtype),
                     pair.intrinsics)


@functools.partial(jax.jit,
                   static_argnames=("intr", "gamma", "cfg", "has_mask"))
def _evaluate_batched_jit(flow_px, rs_image, true_depth, poses_r, poses_t,
                          v_true, w_true, intr, gamma, cfg, keys,
                          pixel_mask=None, has_mask=False):
    """All evaluations of one pair in one device call (lax.map over keys).

    The jittable core of the evaluateVelocities protocol
    (src/errorMeasure.cpp:41-254): estimate → scanline poses → backproject →
    rotation/translation errors + scale-aligned 3D error, per PRNG key.
    """
    dtype = flow_px.dtype
    h = flow_px.shape[0]

    def one(key):
        res = estimate_with_feedback(
            flow_px, intr, gamma, cfg, key,
            pixel_mask=pixel_mask if has_mask else None)
        r_sl, t_sl = scanline_poses(res.v, res.w, res.k, h, gamma,
                                    dtype=dtype)
        rect = backproject(rs_image, res.depth_map, r_sl, t_sl, intr)
        err3d, _, _ = mean_reprojection_error(
            rect.coords_3d, rect.valid, true_depth, poses_r, poses_t, intr)
        err3d_ls, _, _ = mean_reprojection_error(
            rect.coords_3d, rect.valid, true_depth, poses_r, poses_t, intr,
            scale_mode="ls")
        drmse, _ = depth_rmse(res.depth_map, true_depth, res.inlier_mask)
        return (res.w, res.v, res.k,
                rotation_error(res.w, w_true),
                translation_error(res.v, v_true),
                err3d, res.num_inliers, err3d_ls, drmse)

    return jax.lax.map(one, keys)


def evaluate_velocities_batched(
    pair: PairData,
    cfg: PipelineConfig,
    *,
    gamma: Optional[float] = None,
    num_evaluations: int = 50,
    key=None,
    dtype=None,
    flow_px=None,
    true_depth=None,
    pixel_mask=None,
) -> VelocityErrors:
    """evaluate_velocities with all evaluations fused into ONE jitted call.

    The reference protocol repeats the full RANSAC+refinement 50 times per
    configuration (report §5.4); running the repetition as a lax.map inside
    jit amortizes dispatch latency over the 600×600 figure-4/5 sweeps.
    Pass flow_px/true_depth to skip
    recomputation (e.g. f64 renders from a separate process —
    scripts/figure4_protocol.py — or an ESTIMATED dense flow field, which
    together with pixel_mask runs the robust/stress configurations under
    the full repetition protocol).

    Args:
      pixel_mask: optional (H, W) bool of trusted pixels (e.g.
        ~occlusion from flow.dense.flow_forward_backward), applied in
        every evaluation.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    gamma = float(pair.gamma if gamma is None else gamma)
    key = jax.random.PRNGKey(0) if key is None else key
    if flow_px is None:
        flow_px = compute_flow(pair, False, dtype=dtype)
    else:
        flow_px = jnp.asarray(flow_px, dtype)
    if true_depth is None:
        true_depth = true_depth_from_unprojection(
            np.asarray(pair.frame1.rs_unproject),
            np.asarray(pair.frame1.poses_r),
            np.asarray(pair.frame1.poses_t))
    true_depth = jnp.asarray(true_depth, dtype=dtype)
    keys = jax.random.split(key, num_evaluations)
    w, v, k, ew, ev, er, ni, er_ls, drm = _evaluate_batched_jit(
        flow_px, jnp.asarray(pair.frame1.rs_image, dtype), true_depth,
        jnp.asarray(pair.frame1.poses_r, dtype),
        jnp.asarray(pair.frame1.poses_t, dtype),
        jnp.asarray(pair.v, dtype), jnp.asarray(pair.w, dtype),
        pair.intrinsics, gamma, cfg, keys,
        pixel_mask=(jnp.asarray(pixel_mask)
                    if pixel_mask is not None else None),
        has_mask=pixel_mask is not None)
    w, v, k = np.asarray(w).T, np.asarray(v).T, np.asarray(k)
    ew, ev, er = np.asarray(ew), np.asarray(ev), np.asarray(er)
    return VelocityErrors(
        w=w, v=v, k=k, error_w_vec=ew, error_v_vec=ev,
        error_reproject_vec=er,
        error_w=float(np.mean(ew)), error_v=float(np.mean(ev)),
        error_reproject=float(np.nanmean(er)),
        num_inliers=np.asarray(ni),
        error_reproject_ls_vec=np.asarray(er_ls),
        depth_rmse_vec=np.asarray(drm))


def evaluate_velocities(
    pair: PairData,
    cfg: PipelineConfig,
    *,
    gamma: Optional[float] = None,
    num_evaluations: int = 2,
    use_deep_flow: bool = False,
    key=None,
    image_path: Optional[str] = None,
    dtype=None,
    flow_cfg=None,
    use_occlusion_mask: bool = False,
    pixel_mask=None,
) -> VelocityErrors:
    """Run the evaluateVelocities protocol on one pair.

    Args:
      pair: loaded pair with GT (v, w from the task dir).
      cfg: pipeline configuration (the reference harness pins
        tolerance 0.05 — src/errorMeasure.cpp:45 — pass it via cfg).
      gamma: readout ratio (defaults to the pair's GT gamma).
      num_evaluations: repetition count (reference NUM_EVALUATIONS).
      use_deep_flow: dense flow instead of GT flow.
      key: PRNG key (split per evaluation).
      image_path: if given, write per-run depth maps + PLY there
        (src/errorMeasure.cpp:199-230).
      flow_cfg: optional DenseFlowConfig for the dense-flow path (census
        weight, warp engine, search radii — the real-imagery settings).
      use_occlusion_mask: with use_deep_flow, run forward-backward flow and
        exclude occluded pixels from RANSAC/refinement.
      pixel_mask: optional (H, W) bool mask of usable pixels, combined with
        the occlusion mask if both are given.

    Returns:
      VelocityErrors.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    gamma = float(pair.gamma if gamma is None else gamma)
    key = jax.random.PRNGKey(0) if key is None else key
    v_true = jnp.asarray(pair.v, dtype=dtype)
    w_true = jnp.asarray(pair.w, dtype=dtype)

    if use_deep_flow and use_occlusion_mask:
        from rs_sfm_tpu.flow.dense import (DenseFlowConfig,
                                           flow_forward_backward)

        def unit(img):
            arr = jnp.asarray(img, dtype=jnp.float32)
            return arr / 255.0 if np.asarray(img).dtype == np.uint8 else arr

        fb = flow_forward_backward(unit(pair.frame1.rs_image),
                                   unit(pair.frame2.rs_image),
                                   flow_cfg or DenseFlowConfig())
        flow_px = jnp.asarray(fb.flow, dtype)
        occ_free = ~fb.occlusion
        pixel_mask = (occ_free if pixel_mask is None
                      else jnp.asarray(pixel_mask) & occ_free)
    else:
        flow_px = compute_flow(pair, use_deep_flow, dtype=dtype,
                               flow_cfg=flow_cfg)
    h, w_cols = flow_px.shape[:2]
    true_depth = None
    if pair.frame1.rs_unproject is not None:
        true_depth = jnp.asarray(true_depth_from_unprojection(
            np.asarray(pair.frame1.rs_unproject),
            np.asarray(pair.frame1.poses_r),
            np.asarray(pair.frame1.poses_t)), dtype=dtype)

    ws, vs, ks, ew, ev, er, ni = [], [], [], [], [], [], []
    keys = jax.random.split(key, num_evaluations)
    for run, k_i in enumerate(keys):
        res = _estimate_jit(
            flow_px, pair.intrinsics, gamma, cfg, k_i,
            pixel_mask=(jnp.asarray(pixel_mask)
                        if pixel_mask is not None else None),
            has_mask=pixel_mask is not None)
        ws.append(np.asarray(res.w))
        vs.append(np.asarray(res.v))
        ks.append(float(res.k))
        ni.append(int(res.num_inliers))
        ew.append(float(rotation_error(res.w, w_true)))
        ev.append(float(translation_error(res.v, v_true)))

        # Rectify with the estimated motion + depth; 3D error vs GT.
        r_sl, t_sl = scanline_poses(res.v, res.w, res.k, h, gamma,
                                    dtype=dtype)
        rect = backproject(jnp.asarray(pair.frame1.rs_image) if
                           pair.frame1.rs_image.dtype == np.uint8 else
                           jnp.asarray(pair.frame1.rs_image),
                           res.depth_map, r_sl, t_sl, pair.intrinsics)
        if true_depth is not None:
            err3d, _, _ = mean_reprojection_error(
                rect.coords_3d, rect.valid, true_depth,
                jnp.asarray(pair.frame1.poses_r, dtype=dtype),
                jnp.asarray(pair.frame1.poses_t, dtype=dtype),
                pair.intrinsics)
            er.append(float(err3d))
        else:
            er.append(float("nan"))

        if image_path:
            os.makedirs(image_path, exist_ok=True)
            artifacts.imwrite(
                os.path.join(image_path, f"depth_{run}.png"),
                artifacts.depth_image(res.depth_map))
            # Per-evaluation point cloud (the reference writes one PLY per
            # evaluation, src/errorMeasure.cpp:229-230).
            from rs_sfm_tpu.data.ply import write_ply

            write_ply(os.path.join(image_path, f"point_cloud_{run}.ply"),
                      np.asarray(rect.coords_3d),
                      np.asarray(pair.frame1.rs_image),
                      mask=np.asarray(rect.valid))

    return VelocityErrors(
        w=np.stack(ws, axis=1), v=np.stack(vs, axis=1), k=np.asarray(ks),
        error_w_vec=np.asarray(ew), error_v_vec=np.asarray(ev),
        error_reproject_vec=np.asarray(er),
        error_w=float(np.mean(ew)), error_v=float(np.mean(ev)),
        error_reproject=float(np.nanmean(er)) if er else float("nan"),
        num_inliers=np.asarray(ni))
