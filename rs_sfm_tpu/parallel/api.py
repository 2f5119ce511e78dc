"""Sharded estimation entry points.

Two complementary paths:

  estimate_pairs_batched — GSPMD: vmap the jitted pipeline over a batch of
      frame pairs, shard the batch over `pairs` and image rows (scanline
      blocks) over `pixels`, and let XLA partition the elementwise pixel
      work and insert the collectives.  The pipeline is reductions +
      elementwise ops, exactly what GSPMD propagates well.  Verified
      (scripts/check_gspmd_sharding.py, 8-device
      (2 pairs x 4 pixels) mesh, 256px/256 trials): the optimized module
      contains 8 all-reduces + 1 small all-gather + 1 collective-permute
      and NO pixel-scale all-gathers — XLA keeps the pixel axis sharded
      through the reshape/RANSAC/refine chain.

  estimate_sharded — explicit shard_map over scanline blocks for one pair.
      Since round 3 this is a THIN wrapper over the single-device
      solver.pipeline.estimate_from_flow (axis_name): hypotheses draw from
      a globally shared stratified pixel pool (solver.ransac
      shared_sample_pool — 9-point samples span the whole image, not one
      block), scoring reduces votes in one psum per stage, and the
      refinement/k-scan pixel reductions psum over the axis — the
      "distributed Schur" component named in BASELINE.json.  Every
      pipeline feature (multi-start, prescore, acceleration + k-scan)
      runs sharded through the same code path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rs_sfm_tpu.config import PipelineConfig
from rs_sfm_tpu.geom.camera import Intrinsics
from rs_sfm_tpu.solver.pipeline import EstimationResult, estimate_from_flow


def estimate_pairs_batched(mesh: Mesh, intr: Intrinsics, gamma,
                           cfg: PipelineConfig):
    """Build a jitted batched estimator sharded over the mesh.

    Returns a function (flow_batch (B, H, W, 2), keys (B, 2)) ->
    EstimationResult with leading batch axis B; B must divide by the
    `pairs` axis size, H by the `pixels` axis size.
    """

    @jax.jit
    def run(flow_batch, keys):
        flow_batch = jax.lax.with_sharding_constraint(
            flow_batch,
            NamedSharding(mesh, P("pairs", "pixels", None, None)))
        return jax.vmap(
            lambda f, k: estimate_from_flow(f, intr, gamma, cfg, k)
        )(flow_batch, keys)

    return run


# ---------------------------------------------------------------------------
# Explicit shard_map path (scanline-block sharding of a single pair)
# ---------------------------------------------------------------------------


def estimate_sharded(mesh: Mesh, intr: Intrinsics, gamma,
                     cfg: PipelineConfig, *, pool_per_shard: int = 1024,
                     axis: str = "pixels", total_rows: int = None):
    """Build a shard_map'ped single-pair estimator over scanline blocks.

    A thin wrapper: the body IS solver.pipeline.estimate_from_flow with
    axis_name — the same code path as the single-device engine (one place
    computes normalization/α/RANSAC/multi-start/k-scan/refinement for
    both), with the sharding-specific pieces injected:

      * per-shard row offsets so the local block's pixel grid carries
        GLOBAL row coordinates (prepare_flow_inputs row_offset/total_rows);
      * RANSAC sampling from a globally shared stratified pool and
        single-psum vote reduction (solver.ransac axis_name);
      * psum'd 7x7 Schur system / k-scan normal equations / sign flip.

    The full PipelineConfig feature set (multi-start refinement, two-stage
    prescore, acceleration model with k-scan) runs sharded.

    Returns a function (flow (H, W, 2), key) -> EstimationResult whose
    per-pixel fields are sharded over `axis` rows.  H need not divide the
    axis size: rows are zero-flow-padded to a shard multiple (inherently
    invalid under cfg.flow_threshold, so they contribute to no reduction)
    and per-pixel outputs are cropped back (r5, VERDICT r4 item 8).
    """
    n_shards = mesh.shape[axis]
    if pool_per_shard != cfg.ransac_sample_pool:
        import dataclasses

        cfg = dataclasses.replace(cfg, ransac_sample_pool=pool_per_shard)

    def run(flow, key):
        h = flow.shape[0]
        # Non-divisible H: pad rows to a shard multiple with ZERO flow —
        # zero-flow pixels are already invalid under cfg.flow_threshold,
        # so every masked reduction (votes, Schur sums, sign flip) ignores
        # them with no extra mask plumbing; per-pixel outputs are cropped
        # back below.  α/α̃ keep the TRUE row count (readout-time
        # normalization is a property of the image, not the padding).
        hp = -(-h // n_shards) * n_shards
        tr = total_rows if total_rows is not None else h
        if hp != h:
            flow = jnp.pad(flow, ((0, hp - h), (0, 0), (0, 0)))

        def body(flow_block, key, row0):
            # flow_block: (hp/S, W, 2) local scanline block; row0: (1,)
            # global row offset of this block.
            return estimate_from_flow(
                flow_block, intr, gamma, cfg, key, axis_name=axis,
                row_offset=row0[0], total_rows=tr)

        row0 = (jnp.arange(n_shards) * (hp // n_shards)).astype(flow.dtype)
        fn = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis, None, None), P(), P(axis)),
            out_specs=EstimationResult(
                v=P(), w=P(), k=P(), depth_map=P(axis, None),
                inlier_mask=P(axis, None), valid_mask=P(axis, None),
                num_inliers=P(), ransac_v=P(), ransac_w=P(), ransac_k=P(),
                refine_cost=P(), top_v=P(), top_w=P(), top_k=P()),
        )
        res = fn(flow, key, row0)
        if hp != h:
            res = res._replace(depth_map=res.depth_map[:h],
                               inlier_mask=res.inlier_mask[:h],
                               valid_mask=res.valid_mask[:h])
        return res

    return run
