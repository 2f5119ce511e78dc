"""Dump per-pixel estimation products for offline feedback-detector tuning.

For each stress scene (its production preset): flow, FB occlusion,
inlier mask, depth map, and GT EPE — everything needed to analyze which
unocc high-EPE pixels exist and what distinguishes them (flow/feedback.py
depth-coherence tuning) without re-running the flow per parameter choice.

Writes results/flow_dump/feedback_{scene}.npz.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, W = 1080, 1920
GAMMA = 0.9
SCENE_PRESET = {
    "castle_clean": "variational",
    "castle_photo": "robust",
    "stress": "robust",
}


def main():
    import jax

    from rs_sfm_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp

    from rs_sfm_tpu.config import PipelineConfig
    from rs_sfm_tpu.data.synthetic import default_intrinsics
    from rs_sfm_tpu.flow.dense import flow_forward_backward
    from rs_sfm_tpu.models import get_flow_preset
    from rs_sfm_tpu.solver.pipeline import estimate_from_flow

    intr = default_intrinsics(H, W)
    est_cfg = PipelineConfig(ransac_trials=256, ransac_tol=0.02,
                             refine_iterations=20, refine_starts=4,
                             refine_winnow_iters=8, refine_rel_tol=0.0,
                             refine_loss_delta_px=3.0)
    outdir = os.path.join(REPO, "results", "flow_dump")
    os.makedirs(outdir, exist_ok=True)
    cache = os.path.join(REPO, "results", "stress_cache")

    for scene, preset in SCENE_PRESET.items():
        out = os.path.join(outdir, f"feedback_{scene}.npz")
        if os.path.exists(out):
            print("have", out)
            continue
        with np.load(os.path.join(
                cache, f"stress_{H}x{W}_{scene}_v2.npz")) as z:
            data = {k: z[k] for k in z.files}
        fcfg = get_flow_preset(preset)
        fb = flow_forward_backward(jnp.asarray(data["i1"]),
                                   jnp.asarray(data["i2"]), fcfg)
        res = estimate_from_flow(fb.flow, intr, GAMMA, est_cfg,
                                 jax.random.PRNGKey(0),
                                 pixel_mask=~fb.occlusion)
        np.savez_compressed(
            out,
            flow=np.asarray(fb.flow, np.float32),
            occ=np.asarray(fb.occlusion),
            inlier=np.asarray(res.inlier_mask),
            depth=np.asarray(res.depth_map, np.float32),
            v=np.asarray(res.v), w=np.asarray(res.w),
            k=float(res.k),
            gt_flow=data["gt_flow"], mover=data["mover"],
            true_depth=data["true_depth"])
        print("wrote", out, flush=True)


if __name__ == "__main__":
    main()
