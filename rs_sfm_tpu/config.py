"""Global configuration for rs_sfm_tpu.

The reference hard-codes its configuration in `const` blocks at the top of each
driver (reference src/main.cc:164-176, 302-311) and tolerances inside the
engine (src/minimal.cc:39-40, src/errorMeasure.cpp:44-45). Here configuration
is explicit data: a single dataclass threaded through the pipeline.

Dtype policy:
  * Dense per-pixel arrays (images, flow, depth, residuals) are float32 —
    plenty for pixel-level quantities.  Their geometric products ask for
    precision=HIGHEST, so a GPU does not run them in TF32, and the
    refinement's Gram sums are exact-product reductions (ops.linalg.gram).
  * The tiny-core linear algebra (9x9 null space, 3x3 eigendecomposition,
    6x6 char-polynomial for k, 7x7 reduced Schur system) runs in float64 when
    x64 is enabled, else float32.  These matrices are microscopic, so the
    f64 cost is negligible, and the conditioning of the minimal solver
    benefits (reference uses double throughout).

Call `enable_x64()` before creating any JAX arrays to opt in (the CLI and the
test-suite do this).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def enable_x64() -> None:
    """Enable float64 support (call before any JAX arrays are created)."""
    jax.config.update("jax_enable_x64", True)


def core_dtype():
    """Dtype for tiny-core linear algebra (minimal solver, reduced systems)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def dense_dtype():
    """Dtype for dense per-pixel arrays."""
    return jnp.float32


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration.

    Mirrors the reference's driver constants:
      * ransac_trials      — reference `ransac_trials` (src/main.cc:304); the
                             reference default is 5 *sequential* trials, here
                             trials are a batched axis so hundreds are cheap.
      * ransac_tol         — inlier tolerance on normalized flow residual
                             (src/main.cc:310 uses 0.05; report sweeps 0.01).
      * flow_threshold     — squared-pixel-flow cutoff below which a pixel is
                             ignored (src/errorMeasure.cpp:44: 1e-10).
      * use_acceleration   — constant-acceleration model: estimate k
                             (src/main.cc:306 `use_acceleration_mode`).
      * use_global_shutter — GS baseline: alpha ≡ 1, k disabled
                             (src/errorMeasure.cpp:106-111).
      * use_refinement     — run the joint nonlinear refinement
                             (src/main.cc:307).
    """

    ransac_trials: int = 256
    ransac_tol: float = 0.05
    flow_threshold: float = 1e-10
    use_acceleration: bool = False
    use_global_shutter: bool = False
    use_refinement: bool = True
    refine_iterations: int = 50
    # Early-stop tolerance (Ceres function_tolerance analog); 0 = fixed
    # iteration count (leaner compile: static fori_loop).
    refine_rel_tol: float = 1e-8
    # Multi-start refinement (NOT in the reference; divergence documented in
    # README): refine the top-J RANSAC hypotheses independently and keep the
    # one whose refined model re-scores best (#inliers desc, error asc).
    # On noisy estimated flow the minimal-sample winner often sits in the
    # wrong basin of the translation/rotation ambiguity and LM cannot
    # escape; J=4 collapses that seed variance.  1 = reference behavior
    # (refine only the winner).  Cost: J refinements instead of one.
    refine_starts: int = 1
    # Minimum angular separation (radians, up to the ±v gauge) between the
    # v directions of the multi-start hypotheses — keeps the J starts in
    # DISTINCT basins (without it, saturated-consensus problems put all J
    # in one basin and the re-scoring cannot escape it).  0 = plain top-J.
    refine_start_diversity: float = 0.3
    # Winnowing schedule for multi-start refinement (0 = off): run the J
    # batched starts for only this many LM iterations, re-score all J
    # refined candidates against all pixels, keep the lexicographic best,
    # and finish it alone for the remaining refine_iterations.  VarPro LM
    # settles basins in ~8-10 iterations (the 30-iteration production
    # setting is convergence safety, bench refine_cost_rel_delta proof),
    # so the basin RANKING is stable well before full convergence — this
    # buys back most of the J x iteration cost of multi-start.
    refine_winnow_iters: int = 0
    # Bandit-style second winnow stage (r5): after the J-start winnow
    # phase, keep the TOP-2 vote-ranked starts for this many more
    # iterations before the winner finishes alone (4 -> 2 -> 1).  Cuts
    # the full-J batch to fewer iterations where the basin ranking needs
    # a second look before committing.  0 = single winnow stage.
    refine_winnow2_iters: int = 0
    # Deterministic k initialization (constant-acceleration mode): before
    # LM, evaluate the refinement objective on this many k grid points
    # (closed-form ρ + exact linear (v,w) re-fit per point, solver/kscan.py)
    # and start LM from the grid winner.  Kills the f32 k≈−1 mirror-basin
    # convergences (basins are compared by cost, not by which one LM falls
    # into).  0 = off (LM from the RANSAC k̂, the reference-like behavior).
    # Range note: the k cost valley is nearly flat when w≈0 (per-pixel
    # depth absorbs β(k) almost entirely), so the scan only covers the
    # physically moderate range — starting it at the k≈−1 mirror basin's
    # edge lets f32 noise pick the edge on weakly-observable problems
    # (measured).  Widen for extreme-deceleration scenes.
    k_scan_points: int = 17
    k_scan_min: float = -0.5
    k_scan_max: float = 2.0
    k_scan_iters: int = 3
    # Sharded RANSAC sampling (estimate_sharded): stratified pixels each
    # shard contributes to the globally shared 9-point sample pool.
    ransac_sample_pool: int = 1024
    # Two-stage RANSAC scoring: rank hypotheses on this many stratified
    # pixels, full-score only the top ransac_prescore_keep (0 = score all
    # hypotheses on all pixels, the reference's behavior).
    ransac_prescore_subsample: int = 0
    ransac_prescore_keep: int = 16
    # Maximum hypotheses scored at once (memory control: trials are processed
    # in chunks of this size; each chunk materializes a (chunk, N) residual).
    ransac_chunk: int = 64
    # Huber robust loss for the joint refinement, as a PIXEL residual
    # knee (0 = plain L2, the reference's behavior — its Ceres loss hooks
    # are nullptr, src/nonlinearRefinement.cc:131-134).  On estimated
    # flow the loose-tolerance inlier set contains structured smear
    # outliers that bias the L2 fit; the Huber knee (IRLS weights in
    # solver/refine.py) downweights them.  Converted to normalized units
    # with the pair's intrinsics inside estimate_from_flow.
    refine_loss_delta_px: float = 0.0
    # Tight-consensus depth export (0 = off, the reference semantics:
    # depth at every RANSAC inlier).  The loose estimation tolerance
    # (0.02 normalized ≈ 36 px at full-HD f) is required for basin
    # stability on estimated flow, but it admits a fat tail of
    # wrong-flow "inliers" whose depths dominate the 3D error (measured:
    # the flow-accurate 79% of clean-scene inliers carry err3d 0.11 vs
    # 0.36 overall — results/err3d_decompose.json).  With this set, the
    # exported depth map keeps only inliers whose flow the FINAL model
    # fits within this many pixels; pose estimation is unaffected.
    # Deliberate, flag-gated divergence (README "Documented divergences").
    depth_residual_px: float = 0.0
    # Model-feedback passes (solver.pipeline.estimate_with_feedback;
    # flow/feedback.py): after the first estimation, extend the untrusted
    # mask by tight-consensus + depth-coherence + RANSAC outliers against
    # the estimated rigid model, then re-estimate on the trusted set.
    # The one measured lever on the photo/stress err_v frontier
    # (0.127 -> 0.104 pre-Huber, STRESS.md r4); promoted from the r4
    # CLI-only --model-feedback flag into the gated production config
    # (VERDICT r4 item 2).  0 = off (single pass).
    feedback_passes: int = 0
    # Tight-consensus residual tolerance (pixels) for the feedback
    # untrusted-mask extension (flow/feedback.py residual_tol_px).
    feedback_residual_tol_px: float = 2.0
    # How the feedback re-estimation runs:
    #   "refine" — warm-start from the first-pass model: re-score the
    #     trusted set and re-run the Huber-LM refinement only (no second
    #     RANSAC / multi-start; ~1 refinement of marginal cost).  The
    #     mask-bias removal is the lever, and LM re-converges in the same
    #     basin the multi-start selection already picked.
    #   "full" — complete re-estimation (RANSAC + multi-start) on the
    #     trusted mask with a fresh key (the r4 CLI behavior).
    feedback_mode: str = "refine"
    # Basin re-vote before each "refine"-mode feedback pass (r5, ROADMAP
    # 1b attempt): re-score ALL refined diversity-start candidates
    # (EstimationResult.top_*) on the feedback-trusted mask (exact
    # two-stage lexicographic vote, current model wins ties) and
    # warm-start from the winner.  MEASURED NEGATIVE for its purpose and
    # default off: on the 50-eval stress protocol it changed NO
    # evaluation (mean 0.2990 / med 0.0601 bit-for-bit the no-revote
    # rows) — the trusted mask is curated BY the selected
    # model, so when pass 1 picks a wrong basin the mask excludes
    # exactly the dissenting pixels and the vote is circular
    # (STRESS.md r5 final).  A real fix needs
    # model-independent evidence (e.g. per-candidate depth-coherence
    # scoring) — ROADMAP.
    feedback_revote: bool = False
    # LM iteration count for the "refine"-mode feedback re-estimation
    # (0 = refine_iterations).  The re-estimation warm-starts from an
    # ALREADY-CONVERGED model and only has to absorb the trusted-mask
    # delta — it needs far fewer than the cold-start budget (VarPro
    # settles in ~10 from RANSAC inits; from a converged warm start it
    # measures protocol-identical at 8, STRESS.md r5).
    feedback_refine_iterations: int = 0
    # Decimated feedback inpainting (flow/feedback.py): run the
    # depth-coherence peeling and push-pull fill from stride-2-decimated
    # anchor planes (anchors keep exact values at the finest level; the
    # coarse ~50 px-aperture semantics are unchanged).  It measured no
    # faster on the accelerator this was first built for (its strided
    # relayouts cost what the full-res blurs saved) and is kept as a
    # documented option, default off; not measured on a GPU.
    feedback_fast_inpaint: bool = False
    # Fix of the reference's f_x-for-y projection bug (src/rsframe.cc:639).
    # True  -> use f_y for the y coordinate (correct pinhole model).
    # False -> replicate reference behavior bit-for-bit.
    use_fy_in_projection: bool = True
    # Reference relocatePose() skips scanline 0 when rebasing ground-truth
    # poses (loop starts at i=1, src/rsframe.cc:960).  False = rebase all rows
    # (the correct behavior); True = replicate the reference quirk.
    relocate_skip_first_row: bool = False


DEFAULT_CONFIG = PipelineConfig()

# THE production estimation config: gated by tests/test_fullhd_flow.py,
# run by chip_smoke.py, benched by bench.py and exercised by the STRESS.md
# protocol.  4 batched diversity starts for 8 LM iterations, then the vote
# winner alone to 20; Huber loss (3 px knee); tight-consensus depth export
# (2 px); two warm-start model-feedback passes of 8 LM iterations each.
PRODUCTION_CONFIG = PipelineConfig(
    ransac_trials=256, ransac_tol=0.02, refine_iterations=20,
    refine_starts=4, refine_winnow_iters=8, refine_rel_tol=0.0,
    depth_residual_px=2.0, refine_loss_delta_px=3.0, feedback_passes=2,
    feedback_mode="refine", feedback_refine_iterations=8)
