"""Full-HD stress-scene evaluation: dense-flow EPE + estimation quality.

The reference's dominant real-world failure mode is flow corruption by
moving objects and illumination changes at full-HD (examples/README.md:14).
This script renders 1920x1080 stress pairs (moving occluders + foreground
slab; photometric nuisances) with exact GT, then measures on the GPU:

  * dense-flow EPE on rigid (non-mover) pixels per flow preset
    (plain / robust-LCN / census), with occlusion stats and wall-clock;
  * motion-estimation error from the estimated flow, occlusion-masked,
    with the production estimation config (tol 0.02, 4-start refinement);
  * the full 50-evaluation repetition protocol (reference report §5.4)
    via the batched harness, per preset with occlusion masking on/off.

Two-process design like scripts/figure4_protocol.py: --phase render runs
on CPU in f64; the default phase evaluates on the ambient platform (GPU).
Results: results/stress_fullhd.json (tables transcribed into STRESS.md).

Usage:
  python scripts/stress_fullhd.py --out results/stress_fullhd.json
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, W = 1080, 1920
V = np.array([0.35, -0.15, 0.25])
WR = np.array([0.003, -0.002, 0.004])
GAMMA = 0.9

SCENES = ["castle_clean", "castle_photo", "stress"]


def _path(cache, scene):
    # v2: includes per-scanline poses + GT depth for the 3D-error protocol.
    return os.path.join(cache, f"stress_{H}x{W}_{scene}_v2.npz")


def phase_render(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rs_sfm_tpu.data.dataset import true_depth_from_unprojection
    from rs_sfm_tpu.data.synthetic import (apply_photometric, castle_scene,
                                           default_intrinsics, render_pair,
                                           stress_scene)
    from rs_sfm_tpu.flow.true_flow import true_flow

    intr = default_intrinsics(H, W)
    os.makedirs(args.cache, exist_ok=True)
    for name in SCENES:
        path = _path(args.cache, name)
        if os.path.exists(path):
            continue
        scene = (stress_scene(dtype=jnp.float64) if name == "stress"
                 else castle_scene(dtype=jnp.float64))
        pair = render_pair(scene, intr, H, W, gamma=GAMMA, k=0.0, v=V,
                           w=WR, dtype=jnp.float64)
        gt = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                       pair.frame2.poses_t, intr)
        td = true_depth_from_unprojection(
            np.asarray(pair.frame1.rs_unproject),
            np.asarray(pair.frame1.poses_r),
            np.asarray(pair.frame1.poses_t))
        i1 = np.asarray(pair.frame1.rs_image, np.float32)
        i2 = np.asarray(pair.frame2.rs_image, np.float32)
        if name == "castle_photo":
            i2 = np.asarray(apply_photometric(
                jnp.asarray(i2), jax.random.PRNGKey(1), exposure=1.35,
                vignette=0.35, noise_sigma=0.005), np.float32)
        np.savez_compressed(
            path, i1=i1, i2=i2, gt_flow=np.asarray(gt, np.float32),
            mover=np.asarray(pair.frame1.mover_mask), v=V, w=WR,
            poses_r=np.asarray(pair.frame1.poses_r, np.float32),
            poses_t=np.asarray(pair.frame1.poses_t, np.float32),
            true_depth=np.asarray(td, np.float32))
        print(f"[render] {os.path.basename(path)}", flush=True)


def phase_eval(args):
    import jax

    from rs_sfm_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp

    from rs_sfm_tpu.config import PipelineConfig
    from rs_sfm_tpu.data.dataset import FrameData, PairData
    from rs_sfm_tpu.data.synthetic import default_intrinsics
    from rs_sfm_tpu.eval.harness import evaluate_velocities_batched
    from rs_sfm_tpu.eval.metrics import translation_error
    from rs_sfm_tpu.flow.dense import DenseFlowConfig, flow_forward_backward
    from rs_sfm_tpu.models import get_flow_preset
    from rs_sfm_tpu.solver.pipeline import estimate_from_flow

    intr = default_intrinsics(H, W)
    out = {"platform": jax.devices()[0].platform}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        if prev.get("platform") == out["platform"]:
            out = prev

    flow_cfgs = {
        "plain": DenseFlowConfig(),
        "robust": get_flow_preset("robust"),
        "census": get_flow_preset("census"),
    }
    # Production estimation config for estimated flow: loose inlier
    # tolerance (the right basin fits to ~flow-noise precision only; tight
    # tolerances let photoconsistent smear regions out-vote it — measured,
    # STRESS.md), multi-start refinement.
    est_cfg = PipelineConfig(ransac_trials=256, ransac_tol=0.02,
                             refine_iterations=20, refine_starts=4,
                             refine_winnow_iters=8, refine_rel_tol=0.0,
                             depth_residual_px=2.0,
                             refine_loss_delta_px=3.0)

    fb_fn = {}

    def run_fb(cfg_name, i1, i2):
        if cfg_name not in fb_fn:
            cfgv = flow_cfgs[cfg_name]
            fb_fn[cfg_name] = jax.jit(
                lambda a, b: flow_forward_backward(a, b, cfgv))
        r = fb_fn[cfg_name](i1, i2)
        jax.block_until_ready(r.flow)
        return r

    est_jit = jax.jit(lambda fl, mk, key: estimate_from_flow(
        fl, intr, GAMMA, est_cfg, key, pixel_mask=mk))

    for scene in SCENES:
        with np.load(_path(args.cache, scene)) as z:
            data = {k: z[k] for k in z.files}
        i1 = jnp.asarray(data["i1"])
        i2 = jnp.asarray(data["i2"])
        gt = data["gt_flow"]
        mover = data["mover"]
        rigid = ~mover & (np.linalg.norm(gt, axis=-1) > 0)
        row = out.get(scene, {})
        if "auto_preset" not in row:
            from rs_sfm_tpu.flow.auto import probe_flow_preset

            name, stats = probe_flow_preset(i1, i2, return_stats=True)
            row["auto_preset"] = name
            row["auto_stats"] = stats
            out[scene] = row
            _write(args.out, out)
            print(scene, "auto ->", name, stats, flush=True)
        for cfg_name in flow_cfgs:
            if f"err_v_{cfg_name}" in row:
                continue
            fb = run_fb(cfg_name, i1, i2)
            f = np.asarray(fb.flow)
            occ = np.asarray(fb.occlusion)
            epe = np.linalg.norm(f - gt, axis=-1)
            row[f"epe_{cfg_name}_all"] = float(epe[rigid].mean())
            row[f"epe_{cfg_name}_med"] = float(np.median(epe[rigid]))
            row[f"epe_{cfg_name}_unocc"] = float(epe[rigid & ~occ].mean())
            row[f"occ_frac_{cfg_name}"] = float(occ.mean())
            if mover.any():
                row[f"mover_flag_rate_{cfg_name}"] = float(occ[mover].mean())
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                r = fb_fn[cfg_name](i1, i2)
                jax.block_until_ready(r.flow)
                ts.append(time.perf_counter() - t0)
            row[f"fb_ms_{cfg_name}"] = round(min(ts) * 1e3, 1)

            res = est_jit(fb.flow, ~fb.occlusion, jax.random.PRNGKey(0))
            row[f"err_v_{cfg_name}"] = float(translation_error(
                res.v, jnp.asarray(data["v"], jnp.float32)))
            row[f"inlier_frac_{cfg_name}"] = float(
                int(res.num_inliers)) / (H * W)
            inl = np.asarray(res.inlier_mask)
            m_inl = rigid & inl
            if m_inl.any():
                row[f"epe_{cfg_name}_inlier_med"] = float(
                    np.median(epe[m_inl]))

            # Model-feedback pass (VERDICT r4 #7): extended mask +
            # model-corrected flow; the unocc metrics below are the
            # feedback product's trusted-pixel statistics.
            from rs_sfm_tpu.flow.feedback import model_feedback

            fbk = model_feedback(fb.flow, fb.occlusion, res, intr,
                                 GAMMA, est_cfg)
            epe_c = np.linalg.norm(np.asarray(fbk.flow) - gt, axis=-1)
            occ_e = np.asarray(fbk.occlusion)
            row[f"fb_epe_{cfg_name}_unocc"] = float(
                epe_c[rigid & ~occ_e].mean())
            row[f"fb_epe_{cfg_name}_unocc_raw"] = float(
                epe[rigid & ~occ_e].mean())
            row[f"fb_epe_{cfg_name}_all"] = float(epe_c[rigid].mean())
            row[f"fb_epe_{cfg_name}_med"] = float(
                np.median(epe_c[rigid]))
            row[f"fb_occ_frac_{cfg_name}"] = float(occ_e.mean())
            row[f"fb_depth_outlier_frac_{cfg_name}"] = float(
                np.asarray(fbk.depth_outlier).mean())
            out[scene] = row
            _write(args.out, out)
            print(scene, cfg_name,
                  json.dumps({k: v for k, v in row.items()
                              if cfg_name in k}), flush=True)

        # 50-evaluation repetition protocol (reference report §5.4) via the
        # batched harness, occlusion masking on/off, plain + robust.
        pd = PairData(
            frame1=FrameData(
                rs_image=data["i1"], gs_image=None, depth_image=None,
                poses_r=data["poses_r"], poses_t=data["poses_t"],
                rs_unproject=None, gs_unproject=None),
            frame2=None, intrinsics=intr, gamma=GAMMA, k=0.0,
            v=data["v"], w=data["w"])
        for cfg_name in ("plain", "robust"):
            for masked in (True, False):
                key50 = f"protocol_{cfg_name}_{'occl' if masked else 'raw'}"
                if key50 in row:
                    continue
                fb = run_fb(cfg_name, i1, i2)
                errs = evaluate_velocities_batched(
                    pd, est_cfg, gamma=GAMMA,
                    num_evaluations=args.evals,
                    key=jax.random.PRNGKey(11), dtype=jnp.float32,
                    flow_px=np.asarray(fb.flow),
                    true_depth=data["true_depth"],
                    pixel_mask=(~fb.occlusion if masked else None))
                row[key50] = {
                    "err_v_mean": errs.error_v,
                    "err_v_med": float(np.median(errs.error_v_vec)),
                    "err_v_p90": float(np.percentile(errs.error_v_vec, 90)),
                    "err_w_mean": errs.error_w,
                    "err3d_mean": float(np.nanmean(
                        errs.error_reproject_vec)),
                    "err3d_ls_mean": float(np.nanmean(
                        errs.error_reproject_ls_vec)),
                    "depth_rmse_mean": float(np.nanmean(
                        errs.depth_rmse_vec)),
                    "evals": args.evals,
                }
                out[scene] = row
                _write(args.out, out)
                print(scene, key50, json.dumps(row[key50]), flush=True)

    print(f"wrote {args.out}")


def _write(path, out):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="eval", choices=("render", "eval"))
    ap.add_argument("--evals", type=int, default=50)
    ap.add_argument("--cache", default=os.path.join(REPO, "results",
                                                    "stress_cache"))
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "stress_fullhd.json"))
    args = ap.parse_args()
    if args.phase == "render":
        phase_render(args)
        return
    missing = [s for s in SCENES
               if not os.path.exists(_path(args.cache, s))]
    if missing:
        print(f"rendering {missing} in a CPU+f64 subprocess...", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--phase", "render", "--cache", args.cache],
                       check=True)
    phase_eval(args)


if __name__ == "__main__":
    main()
