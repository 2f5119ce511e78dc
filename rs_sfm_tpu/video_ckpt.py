"""Checkpointed long-video processing: windowed estimation with
Orbax-backed resume.

The reference is one-shot per pair (src/main.cc:302-559) and has no notion
of resumable long-sequence processing; the CLI sweep's progress.json
(cli.py) covers parameter sweeps.  This module covers the remaining
checkpoint/resume obligation (SURVEY.md §5): a T-frame video processed in
windows of W pairs, each window's VideoResult saved via
orbax.checkpoint.CheckpointManager.  A crash/preemption resumes at the
first unsaved window; completed windows are restored, not recomputed.

Design notes:
  * window size is static → one jitted graph reused across windows (and
    across runs, via the persistent compilation cache);
  * the last window is padded up to W pairs and masked (fixed shapes);
  * checkpoints are host-side numpy trees (small: per-pair motions + depth
    maps); restore does not need devices and works across device counts.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rs_sfm_tpu.config import PipelineConfig
from rs_sfm_tpu.geom.camera import Intrinsics
from rs_sfm_tpu.video import VideoResult, estimate_video


def _manager(ckpt_dir):
    import orbax.checkpoint as ocp

    return ocp.CheckpointManager(
        os.path.abspath(ckpt_dir),
        options=ocp.CheckpointManagerOptions(max_to_keep=None,
                                             create=True))


def _to_host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def recompute_depth_maps(flows, video: VideoResult, intr: Intrinsics,
                         gamma, cfg: PipelineConfig) -> np.ndarray:
    """Reconstruct per-pair depth maps from stored motions + flow.

    Depth is CLOSED-FORM given (flow, v, w, k) — the per-pixel residual is
    linear in inverse depth — so motions are the only state a video
    checkpoint needs (see process_video_checkpointed(save_depth=False)):
    the depth maps of restored windows are reproduced exactly at ~the cost
    of one RANSAC scoring pass.  Exactness holds for EVERY refine_starts:
    since r5 the pipeline's export is uniformly "closed-form ρ at the
    final model, re-scored inlier mask, tight-consensus gate"
    (solver/pipeline.py), which is precisely what this function computes.
    """
    from rs_sfm_tpu.solver.depth import estimate_inverse_depth
    from rs_sfm_tpu.solver.flow_model import predict_flow
    from rs_sfm_tpu.solver.pipeline import prepare_flow_inputs

    @jax.jit
    def one(flow_px, v, w, k):
        h, w_cols = flow_px.shape[:2]
        coords, flow_n, alpha, alpha_k, valid = prepare_flow_inputs(
            flow_px, intr, gamma, cfg)
        rho = estimate_inverse_depth(coords, flow_n, v, w, k, alpha,
                                     alpha_k)
        u_est = predict_flow(coords, rho, v, w, k, alpha, alpha_k)
        err = jnp.linalg.norm(u_est - flow_n, axis=-1)
        sel = valid & (err < cfg.ransac_tol) & jnp.isfinite(err)
        if cfg.depth_residual_px > 0.0:
            fmean = jnp.sqrt(jnp.asarray(intr.fx * intr.fy, coords.dtype))
            sel = sel & (err * fmean <= cfg.depth_residual_px)
        safe = jnp.where(rho == 0.0, jnp.ones_like(rho), rho)
        z = jnp.where(sel & (rho != 0.0), 1.0 / safe, 0.0)
        return z.reshape(h, w_cols)

    out = []
    for i in range(np.asarray(video.v).shape[0]):
        out.append(np.asarray(one(jnp.asarray(flows[i]),
                                  jnp.asarray(video.v[i]),
                                  jnp.asarray(video.w[i]),
                                  jnp.asarray(video.k[i]))))
    return np.stack(out)


def process_video_checkpointed(
    flows,
    intr: Intrinsics,
    gamma,
    cfg: PipelineConfig,
    key,
    *,
    ckpt_dir: str,
    window: int = 8,
    min_inliers: int = 32,
    save_depth: bool = True,
    on_window: Optional[Callable[[int, VideoResult], None]] = None,
) -> VideoResult:
    """Estimate all pairs of a long sequence with per-window checkpoints.

    Args:
      flows: (P, H, W, 2) per-pair flow fields (device or host array;
        windows are sliced on host so only `window` pairs live on device).
      intr, gamma, cfg, key: as in estimate_video.
      ckpt_dir: checkpoint directory; windows already saved there are
        restored instead of recomputed (resume-after-crash contract).
      window: pairs per window (static; last window padded + masked).
      min_inliers: fault-isolation threshold per pair.
      save_depth: include per-pair depth maps in each checkpoint.  At
        full-HD a depth map is 8.3 MB/pair against ~KB of motions, and
        motions are the only state RESUME needs (depth is closed-form
        from flow + motion — recompute_depth_maps reproduces it exactly),
        so False shrinks checkpoints from ~MB/pair to ~KB/pair.  Restored
        windows then carry zero depth maps in the returned result.
      on_window: optional callback(window_index, window_result).

    Returns:
      VideoResult over all P pairs (host-concatenated).
    """
    import orbax.checkpoint as ocp

    flows_np = np.asarray(flows)
    p = flows_np.shape[0]
    n_win = -(-p // window)
    mgr = _manager(ckpt_dir)
    saved = set(mgr.all_steps())

    run = jax.jit(lambda f, k: estimate_video(
        f, intr, gamma, cfg, k, min_inliers=min_inliers))

    def window_host(wi):
        lo = wi * window
        fw = flows_np[lo:lo + window]
        pad = window - fw.shape[0]
        if pad:
            # Explicitly shaped zeros: `fw[:pad]` would under-pad when
            # the tail window holds fewer than `pad` pairs (e.g. 5 pairs,
            # window=4 → tail has 1 pair but pad=3), breaking the
            # fixed-shape contract of the jitted graph.
            fw = np.concatenate(
                [fw, np.zeros((pad,) + fw.shape[1:], dtype=fw.dtype)],
                axis=0)
        return fw

    # Double-buffered pipeline: jax dispatch is asynchronous, so window
    # wi+1 is uploaded AND enqueued before window wi's result is fetched —
    # the device computes wi+1 while the host fetches wi and writes its
    # checkpoint.  This is the sliding-window analog of the
    # flow(t+1)/solve(t) stage overlap (SURVEY §2.4 PP): the device
    # computes while the host writes, and the save is asynchronous — the
    # durability barrier (wait_until_finished) is
    # taken once at the end, keeping at most one window un-durable during
    # the run.
    def dispatch(wi):
        return run(jnp.asarray(window_host(wi)),
                   jax.random.fold_in(key, wi))

    inflight = {}  # wi -> dispatched (device) VideoResult

    chunks = []
    for wi in range(n_win):
        lo = wi * window
        hi = min(lo + window, p)
        if wi in saved:
            restored = mgr.restore(wi)
            tree = {k: np.asarray(v) for k, v in restored.items()}
            if "depth_maps" not in tree:
                # save_depth=False checkpoints: motions only; depth is
                # reproducible via recompute_depth_maps.
                n_here = tree["v"].shape[0]
                tree["depth_maps"] = np.zeros(
                    (n_here,) + flows_np.shape[1:3], flows_np.dtype)
            res = VideoResult(**tree)
        else:
            out = inflight.pop(wi, None)
            if out is None:
                out = dispatch(wi)
            # Prefetch the next uncheckpointed window before syncing.
            nxt = wi + 1
            if nxt < n_win and nxt not in saved and nxt not in inflight:
                inflight[nxt] = dispatch(nxt)
            res = VideoResult(*_to_host(out))
            res = VideoResult(*[v[: hi - lo] for v in res])
            payload = res._asdict()
            if not save_depth:
                payload = {k: v for k, v in payload.items()
                           if k != "depth_maps"}
            mgr.save(wi, args=ocp.args.StandardSave(payload))
        res = VideoResult(*[v[: hi - lo] for v in res])
        if on_window is not None:
            on_window(wi, res)
        chunks.append(res)

    mgr.wait_until_finished()  # durability barrier for in-flight saves
    mgr.close()
    return VideoResult(*[np.concatenate([getattr(c, f) for c in chunks])
                         for f in VideoResult._fields])
