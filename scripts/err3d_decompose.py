"""Decompose the production-path 3D error (VERDICT r3, next-round item 1).

The stress protocol measures err3d 0.83-1.07 world units on the
photometric/mover scenes vs a 0.005-0.03 GT-flow floor.  This script
attributes that gap on the cached full-HD stress scenes, per scene:

  a. baseline          est flow -> est motion -> est depth, reference
                       mean-ratio scale (exactly the protocol number);
  b. ls_scale          same points, least-squares gauge scale — isolates
                       the scale-ESTIMATOR contribution (heavy-tailed
                       depth ratios bias the reference's mean of ratios);
  c. gt_depth          est motion + GT depth at the same inlier pixels —
                       isolates motion error alone;
  d. gt_motion         GT motion + closed-form depth from the est flow —
                       isolates flow-noise-through-depth;
  e. flow_ok_only      baseline restricted to inlier pixels with GT-flow
                       EPE < 2 px — does residual smear at "inlier"
                       pixels drive the error?
  f. depth_rmse        scale-aligned depth RMSE (ls + median gauges) —
                       the BASELINE north-star metric, reported directly.

Writes results/err3d_decompose.json.

Usage:
  python scripts/err3d_decompose.py
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, W = 1080, 1920
GAMMA = 0.9
OUT = os.path.join(REPO, "results", "err3d_decompose.json")

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
    from rs_sfm_tpu.eval.metrics import depth_rmse, mean_reprojection_error
    from rs_sfm_tpu.flow.dense import DenseFlowConfig, flow_forward_backward
    from rs_sfm_tpu.geom.rspose import scanline_poses
    from rs_sfm_tpu.models import get_flow_preset
    from rs_sfm_tpu.rectify.backproject import backproject
    from rs_sfm_tpu.solver.depth import estimate_inverse_depth
    from rs_sfm_tpu.solver.pipeline import (estimate_from_flow,
                                            prepare_flow_inputs)

    intr = default_intrinsics(H, W)
    est_cfg = PipelineConfig(ransac_trials=256, ransac_tol=0.02,
                             refine_iterations=30, refine_starts=4,
                             refine_rel_tol=0.0)

    out = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            out = json.load(f)

    cache = os.path.join(REPO, "results", "stress_cache")

    for scene, preset in SCENE_PRESET.items():
        if scene in out:
            print(scene, "cached", flush=True)
            continue
        path = os.path.join(cache, f"stress_{H}x{W}_{scene}_v2.npz")
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        i1 = jnp.asarray(data["i1"])
        i2 = jnp.asarray(data["i2"])
        gt_flow = data["gt_flow"]
        v_t = jnp.asarray(data["v"], jnp.float32)
        w_t = jnp.asarray(data["w"], jnp.float32)
        true_depth = jnp.asarray(data["true_depth"], jnp.float32)
        poses_r = jnp.asarray(data["poses_r"], jnp.float32)
        poses_t = jnp.asarray(data["poses_t"], jnp.float32)

        fcfg = get_flow_preset(preset)
        fb = flow_forward_backward(i1, i2, fcfg)
        res = estimate_from_flow(fb.flow, intr, GAMMA, est_cfg,
                                 jax.random.PRNGKey(0),
                                 pixel_mask=~fb.occlusion)
        img = i1

        def rect_err(depth_map, v, w, k, mask, scale_mode="ratio-mean"):
            r_sl, t_sl = scanline_poses(v, w, k, H, GAMMA,
                                        dtype=jnp.float32)
            rect = backproject(img, jnp.where(mask, depth_map, 0.0),
                               r_sl, t_sl, intr)
            e, s, _ = mean_reprojection_error(
                rect.coords_3d, rect.valid, true_depth, poses_r, poses_t,
                intr, scale_mode=scale_mode)
            return float(e), float(s)

        row = {}
        inl = res.inlier_mask
        row["a_baseline"], row["a_scale"] = rect_err(
            res.depth_map, res.v, res.w, res.k, inl)
        row["b_ls_scale"], row["b_scale"] = rect_err(
            res.depth_map, res.v, res.w, res.k, inl, scale_mode="ls")
        row["c_gt_depth"], _ = rect_err(
            true_depth, res.v, res.w, res.k, inl)
        # GT motion, est-flow closed-form depth on the same pixels.
        coords, flow_n, alpha, alpha_k, valid = prepare_flow_inputs(
            fb.flow, intr, GAMMA, est_cfg)
        rho_gtm = estimate_inverse_depth(coords, flow_n, v_t, w_t,
                                         jnp.float32(0.0), alpha, alpha_k)
        z_gtm = jnp.where(rho_gtm != 0.0, 1.0 / jnp.where(
            rho_gtm == 0.0, 1.0, rho_gtm), 0.0).reshape(H, W)
        row["d_gt_motion"], row["d_scale"] = rect_err(
            z_gtm, v_t, w_t, jnp.float32(0.0), inl)
        row["d_gt_motion_ls"], _ = rect_err(
            z_gtm, v_t, w_t, jnp.float32(0.0), inl, scale_mode="ls")
        # Flow-accurate inliers only.
        epe = jnp.linalg.norm(jnp.asarray(gt_flow) - fb.flow, axis=-1)
        ok2 = inl & (epe < 2.0)
        row["e_flow_ok_only"], _ = rect_err(
            res.depth_map, res.v, res.w, res.k, ok2)
        row["e_flow_ok_only_ls"], _ = rect_err(
            res.depth_map, res.v, res.w, res.k, ok2, scale_mode="ls")
        rm_ls, s_ls = depth_rmse(res.depth_map, true_depth, inl)
        rm_med, s_med = depth_rmse(res.depth_map, true_depth, inl,
                                   scale_mode="median")
        row["f_depth_rmse_ls"] = float(rm_ls)
        row["f_depth_rmse_med"] = float(rm_med)
        row["f_depth_scale_ls"] = float(s_ls)
        row["f_depth_scale_med"] = float(s_med)
        row["inlier_frac"] = float(jnp.mean(inl.astype(jnp.float32)))
        row["flow_ok_frac_of_inliers"] = float(
            jnp.sum(ok2) / jnp.maximum(jnp.sum(inl), 1))
        row["mean_true_depth"] = float(jnp.mean(true_depth))
        out[scene] = row
        with open(OUT, "w") as f:
            json.dump(out, f, indent=1)
        print(scene, json.dumps(row, indent=1), flush=True)


if __name__ == "__main__":
    main()
