"""End-to-end motion/depth estimation from a dense flow field.

The jittable equivalent of the reference's driver core
(evaluateSingleRun's flatten→normalize→α→RANSAC→refine→sign-flip→depth-raster
sequence, src/main.cc:398-509, and errorMeasure's variant,
src/errorMeasure.cpp:66-226): one fixed-shape computation from a (H, W, 2)
pixel-flow field to (v, w, k, inverse-depth map, masks).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from rs_sfm_tpu.config import PipelineConfig
from rs_sfm_tpu.geom.camera import (Intrinsics, normalize_coords,
                                    normalize_flow, pixel_grid)
from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu.solver.ransac import (RansacResult, _score_hypotheses,
                                      ransac)
from rs_sfm_tpu.solver.refine import refine


class EstimationResult(NamedTuple):
    v: jax.Array            # (3,)
    w: jax.Array            # (3,)
    k: jax.Array            # ()
    depth_map: jax.Array    # (H, W) Z = 1/ρ at inlier pixels, 0 elsewhere
    inlier_mask: jax.Array  # (H, W) bool
    valid_mask: jax.Array   # (H, W) bool (|flow|² > threshold)
    num_inliers: jax.Array  # () int32
    ransac_v: jax.Array     # (3,) pre-refinement estimates
    ransac_w: jax.Array
    ransac_k: jax.Array
    refine_cost: jax.Array  # () final refinement SSE (0 if refinement off)
    # Refined candidate models for downstream re-votes (the model-feedback
    # basin re-vote, estimate_with_feedback): row 0 is the exported model;
    # rows 1.. are the winnow-stage refined diversity starts when
    # refine_starts > 1 (each sits at the bottom of its own basin after
    # the shared winnow iterations).  (J+1, 3)/(J+1, 3)/(J+1,); J = 0
    # outside the multi-start path.  Scoring is (v, rho)-sign-symmetric,
    # so these rows are NOT sign-flipped.
    top_v: jax.Array
    top_w: jax.Array
    top_k: jax.Array


def prepare_flow_inputs(flow_px, intr: Intrinsics, gamma, cfg: PipelineConfig,
                        *, row_offset=None, total_rows: Optional[int] = None):
    """Flatten + normalize the flow grid and compute RS factors.

    Mirrors src/main.cc:398-434 — normalized coords (x−c)/f, α/α̃ on
    pixel-unit values, validity = |flow_px|² > threshold — except that flow
    is normalized WITHOUT the reference's γ premultiply (see
    geom.camera.normalize_flow), so estimates come out per frame interval.

    Args:
      row_offset: global row index of this block's first row (scanline-block
        sharding under shard_map: the grid y coordinates and α̃ must use
        GLOBAL rows).  None = the block is the whole image.
      total_rows: total image rows H for the α/α̃ scanline-time scaling
        (defaults to the block height — correct only when unsharded).

    Returns:
      (coords (N,2), flow_n (N,2), alpha (N,), alpha_k (N,), valid (N,)).
    """
    h, w_cols = flow_px.shape[:2]
    dtype = flow_px.dtype
    grid = pixel_grid(h, w_cols, dtype=dtype)
    if row_offset is not None:
        grid = grid.at[..., 1].add(jnp.asarray(row_offset, dtype))
    rows = total_rows if total_rows is not None else h
    coords = normalize_coords(grid, intr).reshape(-1, 2)
    flow_n = normalize_flow(flow_px, intr).reshape(-1, 2)
    fpx = flow_px.reshape(-1, 2)
    valid = jnp.sum(fpx * fpx, axis=-1) > cfg.flow_threshold
    alpha = get_alpha(fpx[:, 1], rows, gamma)
    alpha_k = get_alpha_k(grid[..., 1].reshape(-1), fpx[:, 1], rows, gamma)
    if cfg.use_global_shutter:
        # GS baseline: α ≡ 1 (src/errorMeasure.cpp:106-111).
        alpha = jnp.ones_like(alpha)
    return coords, flow_n, alpha, alpha_k, valid


def estimate_from_flow(
    flow_px,
    intr: Intrinsics,
    gamma,
    cfg: PipelineConfig,
    key,
    *,
    axis_name: Optional[str] = None,
    pixel_mask=None,
    row_offset=None,
    total_rows: Optional[int] = None,
    warm_start=None,
) -> EstimationResult:
    """Full estimation: flow grid → (v, w, k) + inverse-depth map.

    Args:
      flow_px: (H, W, 2) dense pixel flow (true or estimated).
      intr: intrinsics; gamma: readout ratio.
      cfg: pipeline configuration.
      key: PRNG key for RANSAC sampling.
      axis_name: collective axis when pixels are sharded (shard_map).  One
        code path serves both layouts: RANSAC samples from a globally
        shared pool and reduces votes in one psum per stage, kscan/refine
        psum their pixel reductions, and the sign flip uses the global mean
        depth.  Scalar outputs are replicated; per-pixel outputs are the
        local scanline block.
      pixel_mask: optional (H, W) bool — pixels where the flow is trusted
        (e.g. ~occlusion from flow.dense.flow_forward_backward).  ANDed
        into the validity mask before RANSAC/refinement; fixed-shape.
      row_offset / total_rows: global row index of this block's first row
        and total image rows (required under axis_name — see
        prepare_flow_inputs).
      warm_start: optional (v, w, k) initial model.  Skips RANSAC and the
        multi-start schedule entirely: the model is scored against all
        pixels for its inlier set and handed straight to the (single)
        refinement — the cheap re-estimation mode of the model-feedback
        second pass (estimate_with_feedback, cfg.feedback_mode="refine").

    Returns:
      EstimationResult on the full (H, W) grid (local block when sharded).
    """
    h, w_cols = flow_px.shape[:2]
    use_k = cfg.use_acceleration and not cfg.use_global_shutter
    coords, flow_n, alpha, alpha_k, valid = prepare_flow_inputs(
        flow_px, intr, gamma, cfg, row_offset=row_offset,
        total_rows=total_rows)
    if pixel_mask is not None:
        valid = valid & pixel_mask.reshape(-1)

    def _psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    if warm_start is not None:
        v_ws = jnp.asarray(warm_start[0], coords.dtype)
        w_ws = jnp.asarray(warm_start[1], coords.dtype)
        k_ws = jnp.asarray(warm_start[2], coords.dtype)
        num_ws, err_ws, rho_ws, inl_ws = _score_hypotheses(
            coords, flow_n, alpha, alpha_k, valid,
            v_ws[None], w_ws[None], k_ws[None], cfg.ransac_tol)
        rr = RansacResult(
            v=v_ws, w=w_ws, k=k_ws, inv_depth=rho_ws[0],
            inlier_mask=inl_ws[0],
            num_inliers=_psum(num_ws[0]).astype(jnp.int32),
            inlier_error=_psum(err_ws[0]),
            top_v=v_ws[None], top_w=w_ws[None], top_k=k_ws[None])
    else:
        with jax.named_scope("ransac"):
            rr = ransac(
                coords, flow_n, alpha, alpha_k, valid,
                key=key, use_k=use_k, trials=cfg.ransac_trials,
                tolerance=cfg.ransac_tol, chunk=cfg.ransac_chunk,
                prescore_subsample=cfg.ransac_prescore_subsample,
                prescore_keep=cfg.ransac_prescore_keep,
                top_j=cfg.refine_starts if cfg.use_refinement else 1,
                top_j_diversity=cfg.refine_start_diversity,
                axis_name=axis_name, sample_pool=cfg.ransac_sample_pool)

    def run_kscan(inlier_mask, v0, w0, k0, rho0):
        if use_k and cfg.k_scan_points > 0:
            from rs_sfm_tpu.solver.kscan import k_scan

            k_grid = jnp.linspace(cfg.k_scan_min, cfg.k_scan_max,
                                  cfg.k_scan_points, dtype=coords.dtype)
            v0, w0, k0, rho0, _ = k_scan(
                coords, flow_n, alpha, alpha_k, inlier_mask, v0, w0,
                k_grid, iters=cfg.k_scan_iters, axis_name=axis_name)
        return v0, w0, k0, rho0

    # Huber knee in normalized units (intrinsics are static trace-time
    # floats).
    loss_delta = (cfg.refine_loss_delta_px
                  / float((intr.fx * intr.fy) ** 0.5)
                  if cfg.refine_loss_delta_px > 0.0 else 0.0)

    @jax.named_scope("refine_lm")
    def run_refine(inlier_mask, v0, w0, k0, rho0):
        v0, w0, k0, rho0 = run_kscan(inlier_mask, v0, w0, k0, rho0)
        return refine(
            coords, flow_n, alpha, alpha_k, inlier_mask,
            v0, w0, k0, rho0,
            optimize_k=use_k, iterations=cfg.refine_iterations,
            rel_tol=cfg.refine_rel_tol, axis_name=axis_name,
            loss_delta=loss_delta)

    if cfg.use_refinement and cfg.refine_starts > 1 and warm_start is None:
        # Multi-start: refine ALL top-J hypotheses as one batched problem —
        # the refinement is vmapped over the starts, which share the pixel
        # record (shared operands broadcast).  Each
        # refined model is re-scored against all pixels and the
        # lexicographic best (#inliers desc, error asc) wins, identical in
        # semantics to refining the starts one at a time (the round-3
        # formulation, which cost ~J x the single-start wall clock).
        # Initial inlier sets + closed-form depths for all J starts at once.
        _, _, rho_j, inl_j = _score_hypotheses(
            coords, flow_n, alpha, alpha_k, valid,
            rr.top_v, rr.top_w, rr.top_k, cfg.ransac_tol)
        v0s, w0s, k0s = rr.top_v, rr.top_w, rr.top_k
        if use_k and cfg.k_scan_points > 0:
            v0s, w0s, k0s, rho_j = jax.vmap(run_kscan)(
                inl_j, v0s, w0s, k0s, rho_j)
        winnow = (cfg.refine_winnow_iters
                  if 0 < cfg.refine_winnow_iters < cfg.refine_iterations
                  else 0)
        multi_iters = winnow if winnow else cfg.refine_iterations

        @jax.named_scope("refine_lm")
        def refine_multi(masks, vs, ws, ks, rhos, iters):
            return jax.vmap(
                lambda m, a, b, c, d: refine(
                    coords, flow_n, alpha, alpha_k, m, a, b, c, d,
                    optimize_k=use_k, iterations=iters,
                    rel_tol=cfg.refine_rel_tol, axis_name=axis_name,
                    loss_delta=loss_delta)
            )(masks, vs, ws, ks, rhos)

        ref = refine_multi(inl_j, v0s, w0s, k0s, rho_j, multi_iters)

        def rescore(vs, ws, ks):
            """Global lexicographic vote; ONE psum of the stacked table
            under sharding (not 2 scalar psums per start).

            The (num desc, err asc) selection is EXACT two-stage — max
            count, then min error among the count winners.  A single f32
            composite score (num*big - err) silently loses error
            differences below ~2^-24 of its magnitude (~4e3 at full-HD
            counts), which re-introduced the seed-bimodal outlier
            evaluations the diversity starts had eliminated (measured:
            protocol means 0.16-0.26 vs medians 0.127 on the r4 stress
            rerun before this fix)."""
            num_r, err_r, rho_r, inl_r = _score_hypotheses(
                coords, flow_n, alpha, alpha_k, valid, vs, ws, ks,
                cfg.ransac_tol)
            votes = _psum(jnp.stack([num_r.astype(err_r.dtype), err_r],
                                    axis=-1))
            num_g = votes[:, 0]
            err_g = jnp.where(jnp.isfinite(votes[:, 1]), votes[:, 1],
                              jnp.inf)
            best_num = jnp.max(num_g)
            err_masked = jnp.where(num_g == best_num, err_g, jnp.inf)
            # Ties keep the earliest (best-scored) start, like the
            # sequential formulation's strict comparisons.
            return jnp.argmin(err_masked), num_g, err_g, rho_r, inl_r

        best_j, num_g, err_g, rho_r, inl_r = rescore(ref.v, ref.w, ref.k)
        # Snapshot the J winnow-stage refined models: each diversity start
        # has descended into its own basin by now, which is exactly the
        # candidate set a later re-vote (on a cleaner trusted mask) wants.
        cand_v, cand_w, cand_k = ref.v, ref.w, ref.k
        winnow2 = (cfg.refine_winnow2_iters
                   if (winnow and cfg.refine_starts > 2
                       and 0 < cfg.refine_winnow2_iters
                       and winnow + cfg.refine_winnow2_iters
                       < cfg.refine_iterations)
                   else 0)
        if winnow2:
            # Bandit-style middle stage (r5, VERDICT r4 item 10): after
            # the J-start winnow phase, keep the TOP-2 starts (by the
            # same exact two-stage vote, second = best among the rest)
            # for winnow2 more iterations before the winner finishes
            # alone — most of the basin ranking is settled early, so the
            # full-J batch runs fewer iterations.
            second_masked = jnp.where(
                jnp.arange(num_g.shape[0]) == best_j, -1.0, num_g)
            second_num = jnp.max(second_masked)
            err_g2 = jnp.where(
                (second_masked == second_num)
                & (jnp.arange(num_g.shape[0]) != best_j),
                err_g, jnp.inf)
            second_j = jnp.argmin(err_g2)
            pick = jnp.stack([best_j, second_j])
            ref = refine_multi(inl_r[pick], ref.v[pick], ref.w[pick],
                               ref.k[pick], rho_r[pick], winnow2)
            best_j, num_g, err_g, rho_r, inl_r = rescore(
                ref.v, ref.w, ref.k)
        if winnow:
            # Finish the winner alone for the remaining iterations from
            # its winnow-phase state (fresh LM damping on its basin).
            v_b = ref.v[best_j]
            w_b = ref.w[best_j]
            k_b = ref.k[best_j]
            ref = refine_multi(inl_r[best_j][None], v_b[None], w_b[None],
                               k_b[None], rho_r[best_j][None],
                               cfg.refine_iterations - winnow - winnow2)
            best_j, num_g, err_g, rho_r, inl_r = rescore(
                ref.v, ref.w, ref.k)
        v, w, k = ref.v[best_j], ref.w[best_j], ref.k[best_j]
        # Use the closed-form ρ at the refined motion (identical optimum to
        # the LM per-pixel depths, but defined consistently with the
        # re-scored inlier set below).
        rho = rho_r[best_j]
        refine_cost = ref.cost[best_j]
        # The winning start's refined inlier set replaces the RANSAC one for
        # depth rasterization and sign disambiguation below.
        rr = rr._replace(inlier_mask=inl_r[best_j],
                         num_inliers=num_g[best_j].astype(jnp.int32))
    elif cfg.use_refinement:
        ref = run_refine(rr.inlier_mask, rr.v, rr.w, rr.k, rr.inv_depth)
        v, w, k = ref.v, ref.w, ref.k
        refine_cost = ref.cost
        cand_v = jnp.zeros((0, 3), coords.dtype)
        cand_w = jnp.zeros((0, 3), coords.dtype)
        cand_k = jnp.zeros((0,), coords.dtype)
        # Export the closed-form ρ at the refined motion with a RE-SCORED
        # inlier set — the same export semantics as the multi-start winner
        # above (LM's per-pixel depths pass rho0 through at out-of-mask
        # pixels, inconsistent with a re-scored mask).  This is also what
        # makes motions-only video checkpoints exactly reproducible for
        # EVERY refine_starts (video_ckpt.recompute_depth_maps).
        num_1, _, rho_1, inl_1 = _score_hypotheses(
            coords, flow_n, alpha, alpha_k, valid,
            v[None], w[None], k[None], cfg.ransac_tol)
        rho = rho_1[0]
        rr = rr._replace(
            inlier_mask=inl_1[0],
            num_inliers=_psum(num_1[0]).astype(jnp.int32))
    else:
        v, w, k, rho = rr.v, rr.w, rr.k, rr.inv_depth
        refine_cost = jnp.zeros((), coords.dtype)
        cand_v = jnp.zeros((0, 3), coords.dtype)
        cand_w = jnp.zeros((0, 3), coords.dtype)
        cand_k = jnp.zeros((0,), coords.dtype)

    # Sign disambiguation: flip v and depths if the mean inlier depth is
    # negative (src/main.cc:466-478).  Depth is Z = 1/ρ on the inlier set.
    safe_rho = jnp.where(rho == 0.0, jnp.ones_like(rho), rho)
    z = jnp.where(rho == 0.0, jnp.zeros_like(rho), 1.0 / safe_rho)
    m = rr.inlier_mask.astype(z.dtype)
    denom = jnp.maximum(_psum(jnp.sum(m)), 1.0)
    z_mean = _psum(jnp.sum(z * m)) / denom
    flip = z_mean < 0.0
    sign = jnp.where(flip, -1.0, 1.0).astype(z.dtype)
    v = v * sign
    z = z * sign

    depth_sel = rr.inlier_mask
    if cfg.depth_residual_px > 0.0:
        # Tight-consensus depth export (see PipelineConfig): keep only
        # inliers whose flow the FINAL model fits within the product
        # tolerance — the loose-tol tail's depths dominate the 3D error.
        from rs_sfm_tpu.solver.flow_model import predict_flow

        u_fin = predict_flow(coords, rho, v * sign, w, k, alpha, alpha_k)
        fmean = jnp.sqrt(jnp.asarray(intr.fx * intr.fy, coords.dtype))
        resid_px = jnp.linalg.norm(u_fin - flow_n, axis=-1) * fmean
        depth_sel = depth_sel & (resid_px <= cfg.depth_residual_px)

    depth_map = jnp.where(depth_sel, z, jnp.zeros_like(z)).reshape(
        h, w_cols)
    return EstimationResult(
        v=v, w=w, k=k,
        depth_map=depth_map,
        inlier_mask=rr.inlier_mask.reshape(h, w_cols),
        valid_mask=valid.reshape(h, w_cols),
        num_inliers=rr.num_inliers,
        ransac_v=rr.v * sign, ransac_w=rr.w, ransac_k=rr.k,
        refine_cost=refine_cost,
        top_v=jnp.concatenate([v[None], cand_v]),
        top_w=jnp.concatenate([w[None], cand_w]),
        top_k=jnp.concatenate([k[None], cand_k]))


def estimate_with_feedback(
    flow_px,
    intr: Intrinsics,
    gamma,
    cfg: PipelineConfig,
    key,
    *,
    pixel_mask=None,
) -> EstimationResult:
    """Estimation with the model-feedback second pass (the PRODUCTION
    entry point; equals estimate_from_flow when cfg.feedback_passes=0).

    Pass 1 estimates on the caller's trusted mask; each feedback pass
    then extends the untrusted set with tight-consensus + RANSAC +
    depth-coherence outliers against the estimated rigid model
    (flow/feedback.py — the one detector that works inside occlusion
    smear bands, where FB round-trip and photoconsistency agree on the
    wrong answer) and re-estimates on the surviving pixels.  The
    re-estimation runs per cfg.feedback_mode: "refine" warm-starts from
    the previous model (no second RANSAC — marginal cost of one Huber-LM
    refinement), "full" repeats the complete schedule.

    Unsharded / vmap-batched paths only: the feedback mask's multi-scale
    inpainting and coarse-smoothing pool across scanline-block boundaries
    and are not shard_map-safe.  The sharded path (parallel.api) runs
    feedback_passes=0 semantics.

    Matches the refinement role of src/nonlinearRefinement.cc:183-252 on
    the robust frontier (VERDICT r4 item 2); measured r4: photo-scene
    err_v 0.127 -> 0.104 (pre-Huber, "full" mode).
    """
    res = estimate_from_flow(flow_px, intr, gamma, cfg, key,
                             pixel_mask=pixel_mask)
    if cfg.feedback_passes <= 0:
        return res
    # Diversity-start candidates of the FIRST estimation, kept across all
    # passes: later passes run warm-start refinement only, so without this
    # set a pass-1 wrong-basin selection could never be revisited (the
    # mover-scene protocol tail, STRESS.md r5 / cfg.feedback_revote).
    cands0 = (res.top_v, res.top_w, res.top_k)
    for p in range(cfg.feedback_passes):
        res, pixel_mask = _feedback_pass(flow_px, intr, gamma, cfg, key, p,
                                         res, pixel_mask, cands0)
    return res


@jax.named_scope("feedback")
def _feedback_pass(flow_px, intr, gamma, cfg, key, p, res, pixel_mask,
                   cands0):
    """One model-feedback pass: extend the untrusted mask against `res`,
    then re-estimate on the trusted pixels."""
    from rs_sfm_tpu.flow.feedback import model_feedback

    h, w_cols = flow_px.shape[:2]
    occ0 = (~pixel_mask if pixel_mask is not None
            else jnp.zeros((h, w_cols), bool))
    fbk = model_feedback(
        flow_px, occ0, res, intr, gamma, cfg,
        residual_tol_px=cfg.feedback_residual_tol_px)
    pixel_mask = ~fbk.occlusion
    if cfg.feedback_mode != "refine":
        warm = None
    elif cfg.feedback_revote and cands0[0].shape[0] > 1:
        # Re-vote {current model} ∪ {first-pass refined starts} on the
        # feedback-trusted mask.  The current model is row 0, so the
        # earliest-index tie-break keeps it unless a dethroned basin
        # strictly wins on the cleaned evidence.
        cv = jnp.concatenate([res.v[None], cands0[0]])
        cw = jnp.concatenate([res.w[None], cands0[1]])
        ck = jnp.concatenate([res.k[None], cands0[2]])
        coords_r, flow_r, al_r, alk_r, val_r = prepare_flow_inputs(
            flow_px, intr, gamma, cfg)
        val_r = val_r & pixel_mask.reshape(-1)
        num_c, err_c, _, _ = _score_hypotheses(
            coords_r, flow_r, al_r, alk_r, val_r, cv, cw, ck,
            cfg.ransac_tol)
        err_c = jnp.where(jnp.isfinite(err_c), err_c, jnp.inf)
        err_m = jnp.where(num_c == jnp.max(num_c), err_c, jnp.inf)
        best_c = jnp.argmin(err_m)
        warm = (cv[best_c], cw[best_c], ck[best_c])
    else:
        warm = (res.v, res.w, res.k)
    cfg_p = cfg
    if warm is not None and cfg.feedback_refine_iterations > 0:
        import dataclasses

        cfg_p = dataclasses.replace(
            cfg, refine_iterations=cfg.feedback_refine_iterations)
    res = estimate_from_flow(flow_px, intr, gamma, cfg_p,
                             jax.random.fold_in(key, 101 + p),
                             pixel_mask=pixel_mask, warm_start=warm)
    return res, pixel_mask
