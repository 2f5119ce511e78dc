"""Error metrics matching the reference's evaluation semantics.

  rotation_error         ‖vee(R_est·R_gtᵀ)‖ with R = I + ŵ small-angle
                         matrices (src/errorMeasure.cpp:179-184)
  translation_error      acos(v·v_gt / ‖v‖‖v_gt‖) (src/errorMeasure.cpp:186)
  mean_reprojection_error  scale-aligned mean 3D distance with the
                         reference's outlier rules (src/camera.cc:593-691)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rs_sfm_tpu.geom import so3
from rs_sfm_tpu.geom.camera import Intrinsics, pixel_grid, plane_to_space
from rs_sfm_tpu.geom.rspose import camera_to_world, relocate_poses

# Per-pixel geometry: a default-precision f32 product may run in TF32 on
# a GPU, ~1e-3 relative, i.e. pixels at f ≈ 1800.
_HI = jax.lax.Precision.HIGHEST


def rotation_error(w_est, w_true):
    """‖vee(R_est·R_trueᵀ)‖ with first-order rotation matrices.

    The reference builds R = I + ŵ directly (small-angle) and multiplies —
    note the product of two first-order matrices is *not* first-order clean;
    this reproduces that exact computation (src/errorMeasure.cpp:125-131,
    179-184).
    """
    r_est = jnp.eye(3, dtype=w_est.dtype) + so3.hat(w_est)
    r_true = jnp.eye(3, dtype=w_est.dtype) + so3.hat(w_true)
    err = jnp.einsum("...ij,...kj->...ik", r_est, r_true, precision=_HI)
    return jnp.linalg.norm(so3.vee(err), axis=-1)


def translation_error(v_est, v_true):
    """Angular error between translation directions (src/errorMeasure.cpp:186)."""
    num = jnp.einsum("...i,...i->...", v_est, v_true, precision=_HI)
    den = jnp.linalg.norm(v_est, axis=-1) * jnp.linalg.norm(v_true, axis=-1)
    safe = jnp.where(den == 0.0, jnp.ones_like(den), den)
    return jnp.arccos(jnp.clip(num / safe, -1.0, 1.0))


def mean_reprojection_error(
    est_coords_3d,
    est_valid,
    true_depth,
    poses_r,
    poses_t,
    intr: Intrinsics,
    *,
    scale_outlier: float = 10.0,
    dist_cap: float = 50.0,
    relocate_skip_first_row: bool = False,
    scale_mode: str = "ratio-mean",
):
    """Scale-aligned mean 3D error (reference Camera::meanReprojectionError).

    Args:
      est_coords_3d: (H, W, 3) estimated world points (from backproject;
        zeros where invalid).
      est_valid: (H, W) bool — pixels with an estimate.
      true_depth: (H, W) ground-truth depth map (camera z per pixel).
      poses_r, poses_t: (H, 3, 3)/(H, 3) *absolute* GT scanline poses of the
        frame; they are relocated here exactly like the reference
        (src/camera.cc:610: frame.relocatePose()).
      intr: intrinsics.
      scale_outlier: per-axis |est/true| ratio beyond which the entry is
        excluded from the mean-scale estimate (src/camera.cc:633-646).
      dist_cap: 3D distances ≥ this are excluded from the mean
        (src/camera.cc:680).
      relocate_skip_first_row: reproduce the reference's relocatePose quirk
        (scanline 0 keeps its absolute pose, src/rsframe.cc:960).
      scale_mode: how the global gauge scale est/true is estimated.
        "ratio-mean" — the reference's estimator: the mean of per-axis
          coordinate ratios with |ratio| > scale_outlier rejected
          (src/camera.cc:629-662).  On noisy per-pixel depths the ratio
          distribution is heavy-tailed (Z = 1/ρ with symmetric ρ noise)
          and the mean is biased — measured to dominate the production
          path's 3D error (scripts/err3d_decompose.py, STRESS.md r4).
        "ls" — the least-squares gauge: s* = Σ⟨e, t⟩ / Σ⟨t, t⟩ over the
          same accepted entries — the LS fit of e ≈ s·t (minimizing
          Σ‖e − s·t‖²; error is then evaluated as ‖e/s − t‖).  Robust in
          practice since inner products average out the heavy tail.  Deliberate
          divergence (flag-gated; the reference-exact estimator remains
          the default for parity runs).

    Returns:
      (mean_error, scale, true_coords_3d (H, W, 3)).
    """
    h, w_cols = true_depth.shape
    dtype = true_depth.dtype
    rel_r, rel_t = relocate_poses(poses_r, poses_t,
                                  skip_first_row=relocate_skip_first_row)
    grid = pixel_grid(h, w_cols, dtype=dtype)
    cam = plane_to_space(grid, true_depth, intr)
    true_3d = camera_to_world(cam, rel_r[:, None], rel_t[:, None])

    # Per-axis scales est/true; entries that are 0, non-finite, or beyond the
    # outlier ratio are dropped from the mean scale (src/camera.cc:629-662).
    ratios = est_coords_3d / true_3d
    ok = (jnp.isfinite(ratios) & (ratios != 0.0)
          & (jnp.abs(ratios) <= scale_outlier)
          & est_valid[..., None])
    denom = jnp.maximum(jnp.sum(ok), 1)
    if scale_mode == "ls":
        num = jnp.sum(jnp.where(ok, est_coords_3d * true_3d, 0.0))
        den = jnp.sum(jnp.where(ok, true_3d * true_3d, 0.0))
        scale = num / jnp.where(den == 0.0, jnp.ones_like(den), den)
    elif scale_mode == "ratio-mean":
        scale = jnp.sum(jnp.where(ok, ratios, 0.0)) / denom
    else:
        raise ValueError(f"unknown scale_mode {scale_mode!r}")

    safe_scale = jnp.where(scale == 0.0, jnp.ones_like(scale), scale)
    dist = jnp.linalg.norm(est_coords_3d / safe_scale - true_3d, axis=-1)
    use = (jnp.isfinite(dist) & (dist < dist_cap) & est_valid
           & jnp.all(jnp.isfinite(true_3d), axis=-1))
    n_used = jnp.maximum(jnp.sum(use), 1)
    mean_err = jnp.sum(jnp.where(use, dist, 0.0)) / n_used
    return mean_err, scale, true_3d


def depth_rmse(depth_est, true_depth, mask, *, scale_mode: str = "ls"):
    """Scale-aligned depth RMSE — the BASELINE north-star depth metric.

    The estimated depth carries the global (v, Z) gauge scale; it is
    aligned to the ground truth before comparison:
      "ls":     s* = Σ m·Z_est·Z_true / Σ m·Z_est²  (LS gauge)
      "median": s* = median(Z_true / Z_est) over the mask (robust)

    Args:
      depth_est: (H, W) estimated depth (0 = no estimate).
      true_depth: (H, W) GT depth.
      mask: (H, W) bool — pixels to score (typically the inlier mask).

    Returns:
      (rmse, scale) — RMSE of (s·Z_est − Z_true) over the mask.
    """
    m = (mask & (depth_est != 0.0) & jnp.isfinite(depth_est)
         & jnp.isfinite(true_depth) & (true_depth > 0.0))
    if scale_mode == "ls":
        num = jnp.sum(jnp.where(m, depth_est * true_depth, 0.0))
        den = jnp.sum(jnp.where(m, depth_est * depth_est, 0.0))
        s = num / jnp.where(den == 0.0, jnp.ones_like(den), den)
    elif scale_mode == "median":
        r = jnp.where(m, true_depth / jnp.where(depth_est == 0.0,
                                                jnp.ones_like(depth_est),
                                                depth_est), jnp.nan)
        s = jnp.nanmedian(r)
    else:
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    d = s * depth_est - true_depth
    n = jnp.maximum(jnp.sum(m), 1)
    rmse = jnp.sqrt(jnp.sum(jnp.where(m, d * d, 0.0)) / n)
    return rmse, s
