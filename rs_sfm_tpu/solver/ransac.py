"""Vectorized RANSAC over the 9-point minimal solver.

The reference runs a handful of *sequential* trials, each reseeding the C
PRNG with `srand(time(NULL))` (src/minimal.cc:230-244 — so all trials within
one wall-clock second draw identical samples) and each paying a full Ceres
depth solve over all pixels (src/minimal.cc:254).  Here:

  * hypotheses are a batch axis: hundreds/thousands of 9-point solves run as
    one fused pass through the batched minimal solver;
  * sampling uses principled jax.random keys (inverse-CDF over the validity
    mask: exact uniform over valid pixels, collision probability ~9²/2V);
  * the per-hypothesis all-pixel depth solve is the closed-form expression
    (solver.depth), so scoring is one elementwise sweep of shape (T, N),
    processed in chunks to bound memory;
  * best-hypothesis selection reproduces the reference's lexicographic rule
    (#inliers desc, then inlier error asc — src/minimal.cc:278) via a
    composite score.

Shapes are fixed: all N pixels stay in place with masks, never compacted
(the reference's compacted-vs-padded discrepancy between errorMeasure and
main is resolved in favor of explicit masking).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from rs_sfm_tpu.solver.depth import estimate_inverse_depth
from rs_sfm_tpu.solver.flow_model import predict_flow
from rs_sfm_tpu.solver.minimal import (calculate_velocities,
                                       calculate_velocities_all_k)

# Per-pixel geometry: a default-precision f32 product may run in TF32 on
# a GPU, ~1e-3 relative, i.e. pixels at f ≈ 1800.
_HI = jax.lax.Precision.HIGHEST


def shared_sample_pool(coords, flow, alpha, alpha_k, valid, pool: int,
                       axis_name: str):
    """Globally shared stratified sample pool under scanline-block sharding.

    Each shard contributes `pool` stratified local pixels; the union is
    shared by writing each shard's slice into its slot of a zeros array and
    psum-ing — a ring all-reduce moves ~2x the bytes of an all_gather, but
    the pool is O(KB) and psum's output is *replicated-typed* under the
    varying-axes analysis, so hypotheses drawn from it are provably
    replicated and shard_map's out_specs checking stays ON.
    """
    n = coords.shape[0]
    stride = max(n // pool, 1)
    idx = (jnp.arange(pool) * stride) % n
    slot = jax.lax.axis_index(axis_name) * pool
    n_shards = jax.lax.psum(1, axis_name)

    def share(x):
        full = jnp.zeros((n_shards * pool,) + x.shape[1:], x.dtype)
        full = jax.lax.dynamic_update_slice_in_dim(full, x[idx], slot, 0)
        return jax.lax.psum(full, axis_name)

    return (share(coords), share(flow), share(alpha), share(alpha_k),
            share(valid.astype(jnp.int32)) > 0)


class RansacResult(NamedTuple):
    """Best-hypothesis output (the reference's RansacValues, src/minimal.h:57-76,
    with masks instead of compacted inlier arrays)."""

    v: jax.Array            # (3,) linear velocity (unit-scale ambiguous)
    w: jax.Array            # (3,) angular velocity
    k: jax.Array            # () acceleration factor
    inv_depth: jax.Array    # (N,) closed-form ρ for every pixel
    inlier_mask: jax.Array  # (N,) bool — residual < tol and pixel valid
    num_inliers: jax.Array  # () int32
    inlier_error: jax.Array  # () summed residual over inliers
    # Top-J hypotheses by composite score (J = the ransac(top_j=...) arg,
    # default 1): multi-start refinement inputs (solver.pipeline).
    top_v: jax.Array = None  # (J, 3)
    top_w: jax.Array = None  # (J, 3)
    top_k: jax.Array = None  # (J,)


def sample_valid_indices(key, valid_mask, trials: int, count: int = 9):
    """(trials, count) indices drawn uniformly from the valid pixels.

    Exact inverse-CDF sampling over the mask; draws are independent, so a
    within-trial collision has probability ~count²/(2·V) (V = #valid) — a
    collision merely yields a rank-deficient hypothesis that loses scoring.
    """
    counts = jnp.cumsum(valid_mask.astype(jnp.int32))
    total = counts[-1]
    u = jax.random.uniform(key, (trials, count))
    targets = 1 + jnp.floor(u * total).astype(jnp.int32)
    targets = jnp.minimum(targets, total)
    return jnp.searchsorted(counts, targets, side="left")


def _score_hypotheses(coords, flow, alpha, alpha_k, valid_mask, v, w, k, tol):
    """Score a chunk of hypotheses against all pixels.

    Args:
      coords/flow: (N, 2); alpha/alpha_k/valid_mask: (N,).
      v, w: (C, 3); k: (C,).

    Returns:
      (num_inliers (C,), inlier_error (C,), inv_depth (C, N),
       inlier (C, N) bool).
    """
    dt = coords.dtype
    vc = v.astype(dt)[:, None, :]
    wc = w.astype(dt)[:, None, :]
    kc = k.astype(dt)[:, None]
    rho = estimate_inverse_depth(
        coords[None], flow[None], vc, wc, kc, alpha[None], alpha_k[None]
    )  # (C, N)
    u_est = predict_flow(coords[None], rho, vc, wc, kc, alpha[None], alpha_k[None])
    err = jnp.linalg.norm(u_est - flow[None], axis=-1)  # (C, N)
    inlier = (err < tol) & valid_mask[None] & jnp.isfinite(err)
    num = jnp.sum(inlier, axis=-1).astype(jnp.int32)
    ierr = jnp.sum(jnp.where(inlier, err, 0.0), axis=-1)
    return num, ierr, rho, inlier


def ransac(
    coords,
    flow,
    alpha,
    alpha_k,
    valid_mask,
    *,
    key,
    use_k: bool,
    trials: int,
    tolerance: float,
    chunk: int = 64,
    k_mode: str = "score",
    prescore_subsample: int = 0,
    prescore_keep: int = 16,
    compat_negate_k: bool = False,
    top_j: int = 1,
    top_j_diversity: float = 0.3,
    axis_name: Optional[str] = None,
    sample_pool: int = 1024,
) -> RansacResult:
    """Batched RANSAC (reference minimal::ransac, src/minimal.cc:209-306).

    Args:
      coords: (N, 2) normalized coordinates (all pixels, masked).
      flow:   (N, 2) normalized γ-scaled flow.
      alpha, alpha_k: (N,) RS factors (pixel-unit inputs already folded in).
      valid_mask: (N,) bool — pixels with |flow|² above threshold.
      key: PRNG key.
      use_k: constant-acceleration model (estimate k per hypothesis).
      trials: number of hypotheses (the reference default is 5; hundreds are
        essentially free here).
      tolerance: inlier threshold on the normalized residual norm.
      chunk: hypotheses scored per pass (memory: chunk × N residual grid).
      k_mode: with use_k, how to choose among the up-to-6 real roots of
        det(Z(k)) per sample: "min" reproduces the reference's smallest-|k|
        heuristic (src/minimal.cc:74-80); "score" (default) expands every
        real root into its own scored hypothesis — strictly stronger, since
        on a minimal sample every root interpolates the 9 constraints and
        only full-set scoring identifies the physical one.
      prescore_subsample: if > 0, two-stage scoring: rank all hypotheses on
        a stratified pixel subsample of this size, then full-score only the
        best `prescore_keep` — an O(T·N) → O(T·S + K·N) reduction.  The
        winning hypothesis is still scored exactly on all pixels; only the
        shortlist selection is approximate.
      prescore_keep: shortlist size for the full-scoring stage.
      top_j: additionally expose the J best-scoring hypotheses in
        RansacResult.top_{v,w,k} for multi-start refinement (the winner is
        always top_v[0] when J == 1).
      axis_name: collective axis when the pixel arrays are a scanline block
        of a sharded image (shard_map).  Sampling then draws from a
        globally shared stratified pool (shared_sample_pool) so 9-point
        samples span the whole image; per-hypothesis votes reduce in ONE
        psum of the stacked (T, 2) vote table per scoring stage — O(1)
        collectives per RANSAC, not per hypothesis.  Scalar outputs
        (v/w/k/num_inliers/top_*) are replicated; inv_depth/inlier_mask
        stay local to the shard's pixels.
      sample_pool: per-shard stratified pool size for sharded sampling.

    Returns:
      RansacResult for the lexicographically best hypothesis.
    """
    n = coords.shape[0]
    solver_dt = jnp.float64 if jax.config.jax_enable_x64 else coords.dtype

    if axis_name is not None:
        # Sampling from the globally shared pool; scoring runs on each
        # shard's local pixel block and the ONE-psum vote merge below
        # combines the shards.
        pool = min(sample_pool, n)
        pc, pf, pa, pak, pv = shared_sample_pool(
            coords, flow, alpha, alpha_k, valid_mask, pool, axis_name)
        idx = sample_valid_indices(key, pv, trials)
        q = pc[idx].astype(solver_dt)       # (T, 9, 2)
        u = pf[idx].astype(solver_dt)
        a9 = pa[idx].astype(solver_dt)      # (T, 9)
        ak9 = pak[idx].astype(solver_dt)
    else:
        idx = sample_valid_indices(key, valid_mask, trials)
        q = coords[idx].astype(solver_dt)   # (T, 9, 2)
        u = flow[idx].astype(solver_dt)
        a9 = alpha[idx].astype(solver_dt)   # (T, 9)
        ak9 = alpha_k[idx].astype(solver_dt)
    if use_k and k_mode == "score":
        w_all, v_all, k_all, valid_h = calculate_velocities_all_k(q, u, a9, ak9)
        w_all = w_all.reshape(-1, 3)
        v_all = v_all.reshape(-1, 3)
        k_all = k_all.reshape(-1)
        valid_h = valid_h.reshape(-1)
        # Disable invalid root slots: zero motion scores zero inliers on any
        # real data, and the composite score demotes it via +inf error.
        zero3 = jnp.zeros_like(w_all)
        w_all = jnp.where(valid_h[:, None], w_all, zero3)
        v_all = jnp.where(valid_h[:, None], v_all, zero3)
        trials_eff = trials * 6
    else:
        w_all, v_all, k_all = calculate_velocities(
            q, u, a9, ak9, use_k, compat_negate_k=compat_negate_k)
        valid_h = jnp.ones((trials,), dtype=bool)
        trials_eff = trials
    trials = trials_eff

    if prescore_subsample and prescore_subsample < n:
        # Stage 1: rank on a stratified subsample (same fixed stride for all
        # hypotheses — differences cancel in the ranking).
        stride = max(n // prescore_subsample, 1)
        sub = (jnp.arange(prescore_subsample) * stride) % n
        c_s, f_s = coords[sub], flow[sub]
        a_s, ak_s, v_s = alpha[sub], alpha_k[sub], valid_mask[sub]
        pad = (-trials) % chunk
        w_p = jnp.concatenate([w_all, jnp.zeros((pad, 3), w_all.dtype)])
        v_p = jnp.concatenate([v_all, jnp.zeros((pad, 3), v_all.dtype)])
        k_p = jnp.concatenate([k_all, jnp.zeros((pad,), k_all.dtype)])

        def pre_chunk(carry, vwk):
            v_c, w_c, k_c = vwk
            num, ierr, _, _ = _score_hypotheses(
                c_s, f_s, a_s, ak_s, v_s, v_c, w_c, k_c, tolerance)
            return carry, (num, ierr)

        _, (pn, pe) = jax.lax.scan(
            pre_chunk, None,
            (v_p.reshape(-1, chunk, 3), w_p.reshape(-1, chunk, 3),
             k_p.reshape(-1, chunk)))
        pn = pn.reshape(-1)[:trials]
        pe = pe.reshape(-1)[:trials]
        sub_total = prescore_subsample
        if axis_name is not None:
            # ONE psum of the stacked vote table (global ranking over the
            # union of the shards' stratified subsamples).
            pvotes = jax.lax.psum(
                jnp.stack([pn.astype(pe.dtype), pe], axis=-1), axis_name)
            pn = pvotes[:, 0].astype(jnp.int32)
            pe = pvotes[:, 1]
            sub_total = prescore_subsample * jax.lax.psum(1, axis_name)
        pn = jnp.where(valid_h, pn, -1)
        big_s = jnp.asarray(sub_total * tolerance + 1.0, pe.dtype)
        pre_score = pn.astype(pe.dtype) * big_s - jnp.where(
            jnp.isfinite(pe), pe, big_s)
        top = jax.lax.top_k(pre_score, prescore_keep)[1]
        w_all = w_all[top]
        v_all = v_all[top]
        k_all = k_all[top]
        valid_h = valid_h[top]
        trials = prescore_keep

    pad = (-trials) % chunk
    if pad:
        w_all_p = jnp.concatenate(
            [w_all, jnp.zeros((pad, 3), w_all.dtype)])
        v_all_p = jnp.concatenate(
            [v_all, jnp.zeros((pad, 3), v_all.dtype)])
        k_all_p = jnp.concatenate(
            [k_all, jnp.zeros((pad,), k_all.dtype)])
    else:
        w_all_p, v_all_p, k_all_p = w_all, v_all, k_all
    w_ch = w_all_p.reshape(-1, chunk, 3)
    v_ch = v_all_p.reshape(-1, chunk, 3)
    k_ch = k_all_p.reshape(-1, chunk)

    def score_chunk(carry, vwk):
        v_c, w_c, k_c = vwk
        num, ierr, _, _ = _score_hypotheses(
            coords, flow, alpha, alpha_k, valid_mask, v_c, w_c, k_c,
            tolerance)
        return carry, (num, ierr)

    _, (nums, ierrs) = jax.lax.scan(
        score_chunk, None, (v_ch, w_ch, k_ch))
    nums = nums.reshape(-1)[:trials]
    ierrs = ierrs.reshape(-1)[:trials]
    n_total = n
    if axis_name is not None:
        # ONE psum of the stacked (T, 2) vote table per RANSAC — not two
        # scalar psums per hypothesis, which would serialize ~2·T
        # collectives.
        votes = jax.lax.psum(
            jnp.stack([nums.astype(ierrs.dtype), ierrs], axis=-1),
            axis_name)
        nums = votes[:, 0].astype(jnp.int32)
        ierrs = votes[:, 1]
        n_total = n * jax.lax.psum(1, axis_name)
    nums = jnp.where(valid_h, nums, -1)

    # Lexicographic (num desc, err asc).  The best-trial pick is EXACT
    # two-stage (max count, then min error among count winners): a single
    # f32 composite (num*big - err) cannot resolve error differences
    # below ~2^-24 of its ~1e10 magnitude at full-HD vote counts, which
    # made equal-count ties effectively arbitrary (measured as residual
    # seed-bimodal protocol evaluations; same fix as the multi-start
    # selection in solver/pipeline.py).  The composite score is kept only
    # where a full ORDERING is needed (top-J diversity scan below and the
    # prescore shortlist), where per-trial count differences dominate.
    # Ties keep the earliest trial, like the reference's strict
    # comparisons (src/minimal.cc:278).
    big = jnp.asarray(n_total * tolerance + 1.0, ierrs.dtype)
    score = nums.astype(ierrs.dtype) * big - jnp.where(
        jnp.isfinite(ierrs), ierrs, big)
    err_clean = jnp.where(jnp.isfinite(ierrs), ierrs, jnp.inf)
    best_num = jnp.max(nums)
    best = jnp.argmin(jnp.where(nums == best_num, err_clean, jnp.inf))

    v_b, w_b, k_b = v_all[best], w_all[best], k_all[best]
    num_b, ierr_b, rho_b, inlier_b = _score_hypotheses(
        coords, flow, alpha, alpha_k, valid_mask,
        v_b[None], w_b[None], k_b[None], tolerance)
    if axis_name is not None:
        bvote = jax.lax.psum(
            jnp.stack([num_b.astype(ierr_b.dtype), ierr_b], axis=-1),
            axis_name)
        num_b = bvote[:, 0].astype(jnp.int32)
        ierr_b = bvote[:, 1]

    if top_j > 1:
        # Multi-start support: expose J hypotheses for downstream
        # refine-and-rescore selection (solver.pipeline refine_starts > 1).
        # Selection is DIVERSITY-FILTERED: greedily take hypotheses in
        # composite-score order whose v direction differs from every
        # already-taken one by more than top_j_diversity radians (up to
        # the ±v gauge).  Without it, on saturated-consensus problems
        # (loose tolerance: every valid pixel is an inlier of several
        # basins) all J starts can come from ONE basin and the re-scoring
        # pick cannot escape it (measured: the pseudo-real full-HD pair,
        # tests/test_real_ingestion.py).  Unfilled slots repeat the best
        # hypothesis.
        if top_j_diversity > 0.0:
            order = jnp.argsort(-score)
            vn = v_all / jnp.maximum(
                jnp.linalg.norm(v_all, axis=-1, keepdims=True), 1e-12)
            cos_thr = jnp.cos(jnp.asarray(top_j_diversity, vn.dtype))
            m_scan = min(score.shape[0], 512)

            def body(i, st):
                sel, selv, cnt = st
                ci = order[i]
                cv = vn[ci]
                filled = jnp.arange(top_j) < cnt
                clash = jnp.any(filled & (jnp.abs(
                    jnp.dot(selv, cv, precision=_HI)) > cos_thr))
                # Only real hypotheses may fill slots: invalid root slots
                # carry v = 0, whose direction never "clashes" — without
                # this gate they would occupy starts when fewer than top_j
                # diverse valid hypotheses exist in the scan window
                # (degenerate zero-motion LM inits instead of the
                # documented repeat-the-best behavior).
                take = (~clash) & (cnt < top_j) & valid_h[ci]
                pos = jnp.minimum(cnt, top_j - 1)
                sel = sel.at[pos].set(jnp.where(take, ci, sel[pos]))
                selv = selv.at[pos].set(jnp.where(take, cv, selv[pos]))
                return sel, selv, cnt + take.astype(cnt.dtype)

            best_i = order[0]
            sel0 = jnp.full((top_j,), best_i, dtype=order.dtype)
            selv0 = jnp.zeros((top_j, 3), vn.dtype)
            tops, _, _ = jax.lax.fori_loop(
                0, m_scan, body, (sel0, selv0, jnp.int32(0)))
        else:
            j_eff = min(top_j, score.shape[0])
            tops = jax.lax.top_k(score, j_eff)[1]
            if j_eff < top_j:
                tops = jnp.concatenate(
                    [tops, jnp.repeat(tops[-1:], top_j - j_eff)])
        top_v, top_w, top_k = v_all[tops], w_all[tops], k_all[tops]
    else:
        top_v, top_w, top_k = v_b[None], w_b[None], k_b[None]

    return RansacResult(
        v=v_b,
        w=w_b,
        k=k_b,
        inv_depth=rho_b[0],
        inlier_mask=inlier_b[0],
        num_inliers=num_b[0],
        inlier_error=ierr_b[0],
        top_v=top_v,
        top_w=top_w,
        top_k=top_k,
    )
