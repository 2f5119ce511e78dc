"""Sliding-window video processing: batched pair estimation over a frame
sequence with per-pair fault isolation.

The reference processes one pair per program run (src/main.cc:302-559); for
video it would re-run per pair.  Here a T-frame sequence becomes T-1
consecutive pairs processed as a batch: flow for all pairs, then the full
estimation pipeline vmapped over pairs — shardable over the `pairs` mesh
axis (pipeline-parallel overlap of flow(t+1) with solve(t) falls out of
batching both stages).

Fault isolation (SURVEY.md §5): a degenerate pair (no texture, zero flow,
broken frame) must not poison the batch.  Every per-pair output carries an
`ok` flag (finite motion + enough inliers); downstream consumers mask on it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rs_sfm_tpu.config import PipelineConfig
from rs_sfm_tpu.geom.camera import Intrinsics
from rs_sfm_tpu.solver.pipeline import EstimationResult, estimate_from_flow

# Per-pixel geometry: a default-precision f32 product may run in TF32 on
# a GPU, ~1e-3 relative, i.e. pixels at f ≈ 1800.
_HI = jax.lax.Precision.HIGHEST


class VideoResult(NamedTuple):
    v: jax.Array            # (P, 3) per-pair linear velocity
    w: jax.Array            # (P, 3)
    k: jax.Array            # (P,)
    depth_maps: jax.Array   # (P, H, W)
    num_inliers: jax.Array  # (P,)
    ok: jax.Array           # (P,) bool — pair produced a usable estimate


def pair_flows_dense(frames, flow_cfg=None):
    """Dense flow for all consecutive pairs of (T, H, W[, 3]) frames.

    Uses lax.map over pairs (each pyramid solve is itself large); returns
    (T-1, H, W, 2).
    """
    from rs_sfm_tpu.flow.dense import DenseFlowConfig, dense_flow

    cfg = flow_cfg or DenseFlowConfig()
    i1 = frames[:-1]
    i2 = frames[1:]
    return jax.lax.map(lambda ab: dense_flow(ab[0], ab[1], cfg), (i1, i2))


def estimate_video(
    flows,
    intr: Intrinsics,
    gamma,
    cfg: PipelineConfig,
    key,
    *,
    min_inliers: int = 32,
) -> VideoResult:
    """Batched estimation over per-pair flow fields (P, H, W, 2).

    vmapped over pairs; works under pjit with the leading axis sharded over
    the `pairs` mesh axis (see parallel.api.estimate_pairs_batched).
    """
    p = flows.shape[0]
    keys = jax.random.split(key, p)
    res: EstimationResult = jax.vmap(
        lambda f, k: estimate_from_flow(f, intr, gamma, cfg, k)
    )(flows, keys)

    finite = (jnp.isfinite(res.v).all(axis=-1)
              & jnp.isfinite(res.w).all(axis=-1)
              & jnp.isfinite(res.k))
    ok = finite & (res.num_inliers >= min_inliers)
    zero3 = jnp.zeros_like(res.v)
    return VideoResult(
        v=jnp.where(ok[:, None], res.v, zero3),
        w=jnp.where(ok[:, None], res.w, zero3),
        k=jnp.where(ok, res.k, jnp.zeros_like(res.k)),
        depth_maps=jnp.where(ok[:, None, None], res.depth_map,
                             jnp.zeros_like(res.depth_map)),
        num_inliers=res.num_inliers,
        ok=ok)


def accumulate_trajectory(video: VideoResult, gamma, rows: int):
    """Chain per-pair frame-interval motions into an approximate camera
    trajectory (first-order composition, constant velocity per pair).

    Returns (R (P+1, 3, 3), t (P+1, 3)) world→camera poses of each frame's
    scanline 0, with frame 0 at identity.  Pairs flagged not-ok contribute
    identity motion (pose hold) — the fault-isolation contract.
    """
    from rs_sfm_tpu.geom import so3

    def step(carry, vw):
        r_acc, t_acc = carry
        v, w, ok = vw
        dr = so3.exp_first_order(w)
        dr = jnp.where(ok, dr, jnp.eye(3, dtype=dr.dtype))
        dv = jnp.where(ok, v, jnp.zeros_like(v))
        r_new = jnp.einsum("ij,jk->ik", dr, r_acc, precision=_HI)
        t_new = jnp.einsum("ij,j->i", dr, t_acc, precision=_HI) + dv
        return (r_new, t_new), (r_new, t_new)

    r0 = jnp.eye(3, dtype=video.v.dtype)
    t0 = jnp.zeros(3, dtype=video.v.dtype)
    _, (rs, ts) = jax.lax.scan(step, (r0, t0), (video.v, video.w, video.ok))
    r_all = jnp.concatenate([r0[None], rs], axis=0)
    t_all = jnp.concatenate([t0[None], ts], axis=0)
    return r_all, t_all
