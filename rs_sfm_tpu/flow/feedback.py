"""Model-feedback occlusion masking and flow correction (VERDICT r4 #7).

The dominant residual flow failure at full-HD is the occlusion SMEAR band:
background pixels next to a moving foreground edge inherit the
foreground's flow, and because both the backward flow and the warped
texture are consistently wrong there (repetitive texture), every local
detector — forward-backward round trip, photoconsistency — agrees on the
wrong answer (STRESS.md, measured; this is the reference's example-4
failure family, /root/reference/examples/README.md:14).  What does catch
these pixels is the rigid RS model itself: they score as RANSAC outliers.

This module feeds that model consensus back into the flow product:

  * `occlusion` is EXTENDED by the model-outlier set (valid pixels whose
    flow the estimated rigid model rejects at the RANSAC tolerance) — the
    trusted-pixel mask downstream consumers get now reflects the one
    detector that works in the smear bands;
  * the flow at those pixels is REPLACED by the rigid-model prediction
    computed from a push-pull-inpainted inverse-depth field (per-pixel
    depths diffused outward from the inlier anchors at successively
    coarser scales).  In a smear band the nearest anchors are the
    surrounding background inliers, so the inpainted depth — and with it
    the predicted flow — recovers the background motion the local data
    term could not see.

The corrected flow serves rectification-adjacent consumers and the flow
metrics; the estimation path keeps scoring only non-extended pixels (the
substituted flow is model-derived and would be circular as estimation
evidence).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rs_sfm_tpu.config import PipelineConfig
from rs_sfm_tpu.flow.dense import _downsample, _gauss_blur
from rs_sfm_tpu.geom.camera import Intrinsics
from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu.solver.flow_model import predict_flow
from rs_sfm_tpu.solver.pipeline import EstimationResult, prepare_flow_inputs


class FeedbackResult(NamedTuple):
    flow: jax.Array        # (H, W, 2) corrected pixel flow
    occlusion: jax.Array   # (H, W) bool — extended untrusted-pixel mask
    model_flow: jax.Array  # (H, W, 2) rigid-model flow (inpainted depth)
    outlier: jax.Array     # (H, W) bool — model-outlier extension alone
    depth_outlier: jax.Array  # (H, W) bool — depth-coherence extension
    trusted_depth: jax.Array  # (H, W) bool — inliers surviving both tests


def _up2_to(x, shape):
    """2x bilinear upsample cropped to the parent level's shape."""
    return jax.image.resize(x, shape, method="bilinear")


def _coarse_smooth(values, weights, down: int = 3, blurs: int = 3,
                   decimate: bool = False):
    """Normalized convolution at a coarse scale (aperture ~ 2^down * 2 *
    blurs px): the reference neighborhood for the depth-coherence test —
    it must be WIDER than a smear band so the band cannot dominate its
    own comparison value (the finest-scale push-pull fill does exactly
    that and is blind to coherent bands — measured).

    decimate: replace the first (full-resolution) blur+downsample level
    with a plain stride-2 decimation of the anchor planes.  A normalized-
    conv AVERAGE tolerates the aliasing (half the anchors simply drop out
    of a ~50 px-aperture mean), and it removes every full-resolution blur
    from the chain — the feedback pass's cost driver
    (cfg.feedback_fast_inpaint)."""
    num = values * weights
    den = weights
    shapes = []
    if decimate and down > 0:
        shapes.append(num.shape)
        num = num[::2, ::2]
        den = den[::2, ::2]
        down -= 1
    for _ in range(down):
        shapes.append(num.shape)
        num = _downsample(_gauss_blur(num))
        den = _downsample(_gauss_blur(den))
    for _ in range(blurs):
        num = _gauss_blur(num)
        den = _gauss_blur(den)
    sm = num / jnp.maximum(den, 1e-9)
    for shape in reversed(shapes):
        sm = _up2_to(sm, shape)
    return sm


def _push_pull_fill(values, weights, levels: int = 6,
                    decimate: bool = False):
    """Normalized-convolution push-pull inpainting.

    Fills weight-0 pixels with the nearest-scale weighted average of the
    anchored values: downsample (value*w, w) `levels` times, then walk
    back up replacing empty pixels by the coarser fill — every pixel ends
    at the finest scale that had support.  O(N) total work.

    decimate: skip the finest level's blur — the level-0 pull step
    becomes `where(anchored, exact value, half-res fill)` (anchors keep
    their EXACT values instead of a 3x3 blur average; everything else
    comes from the stride-2-decimated chain).  Removes the two
    full-resolution blurs (cfg.feedback_fast_inpaint).
    """
    num = values * weights
    den = weights
    stack = []
    if decimate and levels > 0:
        stack.append((num, den))
        num = num[::2, ::2]
        den = den[::2, ::2]
        levels -= 1
    for _ in range(levels):
        num = _gauss_blur(num)
        den = _gauss_blur(den)
        stack.append((num, den))
        num = num[::2, ::2]
        den = den[::2, ::2]
    fill = num / jnp.maximum(den, 1e-12)
    for num_l, den_l in reversed(stack):
        up = _up2_to(fill, num_l.shape)
        fill = jnp.where(den_l > 1e-6, num_l / jnp.maximum(den_l, 1e-12),
                         up)
    return fill


def model_feedback(flow_px, occlusion, res: EstimationResult,
                   intr: Intrinsics, gamma, cfg: PipelineConfig,
                   *, fill_levels: int = 6, depth_tau: float = 0.5,
                   depth_rounds: int = 2,
                   residual_tol_px: float = 2.0) -> FeedbackResult:
    """Extend the occlusion mask by model outliers and correct their flow.

    Three outlier families are fed back:
      * tight-consensus outliers — the PRODUCTION lever (measured on the
        full-HD dumps): the estimation tolerance must stay loose
        (ransac_tol 0.02 ≈ 36 px of orthogonal slack at full-HD f — the
        basin-stability requirement, STRESS.md §4), so the "inlier" set
        admits a fat tail of wrong-flow pixels (20% of unocc pixels above
        2 px EPE carrying 96% of the unocc mean on castle_clean).  The
        trusted-product mask re-tests every pixel against the FINAL
        refined model at residual_tol_px (default 2 px): keeps ~86-91% of
        the unocc pixels and drops their mean EPE 3.08 → ~1.0 px;
      * RANSAC outliers — flow the rigid model rejects outright;
      * depth-coherence outliers — the insidious case: smear flow that is
        nearly EPIPOLAR-CONSISTENT stays an inlier (the per-pixel free
        depth absorbs any error along the A·v direction) but lands at the
        foreground's depth inside a background band.  These are peeled by
        the signed near-side test against a coarse-scale neighborhood
        (see _coarse_smooth) for depth_rounds rounds — the first round
        removes the band core, the trimmed re-smooth then exposes its
        rim.

    Args:
      flow_px: (H, W, 2) first-pass dense flow (pixels).
      occlusion: (H, W) bool first-pass FB/photoconsistency mask.
      res: EstimationResult of the first-pass estimation on this flow.
      intr, gamma, cfg: the estimation context (tolerance, GS mode...).
      depth_tau: relative near-side ρ inflation flagged as incoherent
        (signed: only nearer-than-neighborhood bands trigger; the far
        side of genuine depth edges never does).
      depth_rounds: peel iterations (0 disables the depth test).

    Returns:
      FeedbackResult.
    """
    h, w_cols = flow_px.shape[:2]
    dtype = flow_px.dtype

    depth = res.depth_map
    inl = res.inlier_mask & (depth != 0.0)
    rho_pix = jnp.where(inl, 1.0 / jnp.where(depth == 0.0,
                                             jnp.ones_like(depth), depth),
                        0.0)

    # Depth-coherence peeling over the inlier set.  SIGNED near-side
    # test: smear inherits the FOREGROUND's depth, so its ρ is inflated
    # relative to the coarse neighborhood — a thin "nearer" band not
    # attached to a larger near structure is physically implausible,
    # while the far side of genuine depth edges never triggers.
    fast = bool(cfg.feedback_fast_inpaint)
    trust = inl
    depth_out = jnp.zeros_like(inl)
    for _ in range(depth_rounds):
        rho_sm = _coarse_smooth(rho_pix, trust.astype(dtype),
                                decimate=fast)
        bad = trust & (rho_pix > rho_sm * (1.0 + depth_tau))
        depth_out = depth_out | bad
        trust = trust & ~bad

    # Inpainted inverse depth from the SURVIVING anchors.
    rho_fill = _push_pull_fill(rho_pix, trust.astype(dtype),
                               levels=fill_levels, decimate=fast)

    # Rigid-model flow at every pixel.  α/α̃ depend on the pixel flow's y
    # component, which for the smear pixels is exactly what is wrong — so
    # iterate the α fixed point starting from the observed flow and
    # re-evaluating at the model prediction (converges in 2 passes; the
    # correction is O(γ·Δflow_y/h)).
    coords, _, alpha, alpha_k, _ = prepare_flow_inputs(flow_px, intr, gamma,
                                                       cfg)
    rho_flat = rho_fill.reshape(-1)
    fscale = jnp.asarray([intr.fx, intr.fy], dtype)
    grid_y = jnp.tile(jnp.arange(h, dtype=dtype)[:, None],
                      (1, w_cols)).reshape(-1)
    model_n = predict_flow(coords, rho_flat, res.v, res.w, res.k,
                           alpha, alpha_k)
    for _ in range(1):
        fy_px = model_n[:, 1] * intr.fy
        alpha2 = get_alpha(fy_px, h, gamma)
        alpha2 = jnp.where(jnp.asarray(cfg.use_global_shutter),
                           jnp.ones_like(alpha2), alpha2)
        alpha_k2 = get_alpha_k(grid_y, fy_px, h, gamma)
        model_n = predict_flow(coords, rho_flat, res.v, res.w, res.k,
                               alpha2, alpha_k2)
    model_px = (model_n * fscale).reshape(h, w_cols, 2)

    # Model-outlier extension: valid pixels the rigid model rejects, OR
    # pixels whose best-depth residual against the final model exceeds
    # the tight product tolerance (per-pixel closed-form ρ ⇒ the residual
    # is the component orthogonal to the epipolar direction).
    coords2, flow_obs_n, alpha_o, alpha_ko, _ = prepare_flow_inputs(
        flow_px, intr, gamma, cfg)
    from rs_sfm_tpu.solver.depth import estimate_inverse_depth

    rho_best = estimate_inverse_depth(coords2, flow_obs_n, res.v, res.w,
                                      res.k, alpha_o, alpha_ko)
    u_best = predict_flow(coords2, rho_best, res.v, res.w, res.k,
                          alpha_o, alpha_ko)
    fmean = jnp.sqrt(jnp.asarray(intr.fx * intr.fy, dtype))
    resid_px = (jnp.linalg.norm(u_best - flow_obs_n, axis=-1)
                * fmean).reshape(h, w_cols)
    tight_out = res.valid_mask & (resid_px > residual_tol_px)
    outlier = (res.valid_mask & ~res.inlier_mask) | tight_out
    occ_ext = occlusion | outlier | depth_out

    flow_out = jnp.where(occ_ext[..., None], model_px, flow_px)
    return FeedbackResult(flow=flow_out, occlusion=occ_ext,
                          model_flow=model_px, outlier=outlier,
                          depth_outlier=depth_out, trusted_depth=trust)
