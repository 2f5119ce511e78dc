"""Reference figure-4/5 accuracy protocol, at the reference's own scale.

Reproduces the report's three synthetic sweeps exactly as generated by
/root/reference/matlab_synthetic_data/castle.m:11-30 + start_generating.m:
  left    gamma in {0, 0.1, ..., 1.0}, k=0, w=0,      v=0.03*[1,1,0]
  middle  gamma=0.8, k in {0, 0.5, 1, 1.5}, w=0.05 deg z, v=0.02*[1,1,0]
  right   gamma=0.8, k=0, w=0.05 deg z, v in {0..0.06}*[1,1,0]
with v scaled by the scene mean depth (start_generating.m:88-90), w given
in degrees (calculate_camera_trajectory.m:6), 600x600 renders, and the
report's evaluation protocol: 50 evaluations x 50 RANSAC trials, inlier
tolerance 0.01, ground-truth flow (src/main.cc:165-166, report section 5.4).
The left/right sweeps run both RS-aware and GS-assumption estimators
(figure 5 left/right); the middle sweep runs const-acceleration and
const-velocity models (figure 5 middle).

Two-process design (enabling x64 in the GPU process would promote library
ints to s64 and move the production path off f32): the driver spawns a
CPU+f64 subprocess (--phase render) that renders each configuration and
computes exact GT flow + GT depth into an .npz cache; the driver itself
then runs the estimation sweeps — f32 on the GPU (production path) or f64
on CPU with --platform cpu (reference-precision cross-check).
Per-configuration
results are checkpointed into the output JSON, so interrupted runs resume.

Usage:
  python scripts/figure4_protocol.py \
      --sweeps left middle right --out results/figure4_gpu.json
  python scripts/figure4_protocol.py --platform cpu --evals 5 \
      --sweeps left --gammas 0,0.5,0.9 --out results/figure4_cpu64.json
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

W_REF = 0.05 * np.pi / 180.0  # 0.05 deg about z (castle.m:21,27)


def config_list(sweeps, gammas_override=None):
    cfgs = []
    if "left" in sweeps:
        gammas = (gammas_override or
                  [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0])
        for g in gammas:
            for mode in ("rs", "gs"):
                cfgs.append(dict(sweep="left", gamma=g, k=0.0, v_mag=0.03,
                                 w_mag=0.0, model=mode))
    if "middle" in sweeps:
        for k in (0.0, 0.5, 1.0, 1.5):
            for mode in ("accel", "constvel"):
                cfgs.append(dict(sweep="middle", gamma=0.8, k=k, v_mag=0.02,
                                 w_mag=W_REF, model=mode))
    if "right" in sweeps:
        for vm in (0.0, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06):
            for mode in ("rs", "gs"):
                cfgs.append(dict(sweep="right", gamma=0.8, k=0.0, v_mag=vm,
                                 w_mag=W_REF, model=mode))
    return cfgs


def render_name(c, size):
    return (f"render_{size}_g{c['gamma']:g}_k{c['k']:g}_v{c['v_mag']:g}"
            f"_w{c['w_mag']:.6f}.npz")


def phase_render(args):
    """CPU + f64 subprocess: exact renders, GT flow, GT depth → npz cache."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rs_sfm_tpu.data.dataset import true_depth_from_unprojection
    from rs_sfm_tpu.data.synthetic import (castle_scene, default_intrinsics,
                                           render_pair)
    from rs_sfm_tpu.flow.true_flow import true_flow

    size = args.size
    intr = default_intrinsics(size, size)
    scene = castle_scene(dtype=jnp.float64)

    probe = render_pair(scene, intr, size, size, gamma=0.0, k=0.0,
                        v=np.zeros(3), w=np.zeros(3), dtype=jnp.float64)
    td0 = np.asarray(true_depth_from_unprojection(
        probe.frame1.rs_unproject, probe.frame1.poses_r,
        probe.frame1.poses_t))
    mean_depth = float(td0[td0 > 0].mean())
    os.makedirs(args.cache, exist_ok=True)
    with open(os.path.join(args.cache, f"meta_{size}.json"), "w") as f:
        json.dump({"mean_depth": mean_depth}, f)
    print(f"[render] scene mean depth = {mean_depth:.4f}", flush=True)

    for c in config_list(args.sweeps, _parse_gammas(args.gammas)):
        path = os.path.join(args.cache, render_name(c, size))
        if os.path.exists(path):
            continue
        v = c["v_mag"] * mean_depth * np.array([1.0, 1.0, 0.0])
        w = np.array([0.0, 0.0, c["w_mag"]])
        pair = render_pair(scene, intr, size, size, gamma=c["gamma"],
                           k=c["k"], v=v, w=w, dtype=jnp.float64)
        flow = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                         pair.frame2.poses_t, intr)
        td = true_depth_from_unprojection(
            pair.frame1.rs_unproject, pair.frame1.poses_r,
            pair.frame1.poses_t)
        np.savez_compressed(
            path,
            flow_px=np.asarray(flow),
            rs_image=np.asarray(pair.frame1.rs_image, np.float32),
            poses_r=np.asarray(pair.frame1.poses_r),
            poses_t=np.asarray(pair.frame1.poses_t),
            true_depth=np.asarray(td), v=v, w=w)
        print(f"[render] {os.path.basename(path)}", flush=True)


def _parse_gammas(s):
    return [float(g) for g in s.split(",")] if s else None


def phase_eval(args):
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from rs_sfm_tpu.config import PipelineConfig
    from rs_sfm_tpu.data.dataset import FrameData, PairData
    from rs_sfm_tpu.data.synthetic import default_intrinsics
    from rs_sfm_tpu.eval.harness import evaluate_velocities_batched

    size = args.size
    intr = default_intrinsics(size, size)
    with open(os.path.join(args.cache, f"meta_{size}.json")) as f:
        mean_depth = json.load(f)["mean_depth"]
    dtype = jnp.float64 if args.platform == "cpu" else jnp.float32

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f).get("results", {})
        print(f"resuming: {len(results)} configuration(s) done", flush=True)

    for c in config_list(args.sweeps, _parse_gammas(args.gammas)):
        name = (f"{c['sweep']}_g{c['gamma']:g}_k{c['k']:g}"
                f"_v{c['v_mag']:g}_{c['model']}")
        if name in results:
            continue
        with np.load(os.path.join(args.cache, render_name(c, size))) as z:
            data = {k: z[k] for k in z.files}
        pd = PairData(
            frame1=FrameData(
                rs_image=data["rs_image"], gs_image=None, depth_image=None,
                poses_r=data["poses_r"], poses_t=data["poses_t"],
                rs_unproject=None, gs_unproject=None),
            frame2=None, intrinsics=intr, gamma=c["gamma"], k=c["k"],
            v=data["v"], w=data["w"])
        cfg = PipelineConfig(
            ransac_trials=args.trials, ransac_tol=args.tol,
            refine_iterations=50,
            use_acceleration=(c["model"] == "accel"),
            use_global_shutter=(c["model"] == "gs"),
            # f32 k estimation is bimodal under the k/(v,w,rho) trade-off
            # (ACCURACY.md (b)): multi-start refinement collapses the bad
            # basin.  f64 is insensitive to this setting.
            refine_starts=4 if c["model"] == "accel" else 1)
        errs = evaluate_velocities_batched(
            pd, cfg, gamma=c["gamma"], num_evaluations=args.evals,
            key=jax.random.PRNGKey(7), dtype=dtype,
            flow_px=data["flow_px"], true_depth=data["true_depth"])
        row = dict(
            c,
            err3d_mean=float(np.nanmean(errs.error_reproject_vec)),
            err3d_std=float(np.nanstd(errs.error_reproject_vec)),
            err_v=errs.error_v, err_w=errs.error_w,
            k_mean=float(np.mean(errs.k)), k_std=float(np.std(errs.k)),
            inliers_mean=float(np.mean(errs.num_inliers)))
        results[name] = row
        print(f"{name}: 3D={row['err3d_mean']:.4f}±{row['err3d_std']:.4f} "
              f"err_v={row['err_v']:.5f} err_w={row['err_w']:.6f} "
              f"k_hat={row['k_mean']:+.3f}", flush=True)
        with open(args.out, "w") as f:
            json.dump({"protocol": {k: v for k, v in vars(args).items()}
                       | {"mean_depth": mean_depth},
                       "results": results}, f, indent=1)

    print(f"wrote {args.out} ({len(results)} configurations)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="eval", choices=("render", "eval"))
    ap.add_argument("--platform", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--size", type=int, default=600)
    ap.add_argument("--evals", type=int, default=50)
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--sweeps", nargs="+",
                    default=["left", "middle", "right"])
    ap.add_argument("--gammas", default=None,
                    help="comma list overriding the left sweep's gammas")
    ap.add_argument("--cache", default=os.path.join(REPO, "results",
                                                    "fig4_cache"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.phase == "render":
        phase_render(args)
        return
    if not args.out:
        ap.error("--out is required for --phase eval")
    # Ensure the render cache exists (separate process: CPU + f64).
    missing = [c for c in config_list(args.sweeps, _parse_gammas(args.gammas))
               if not os.path.exists(os.path.join(args.cache,
                                                  render_name(c, args.size)))]
    if missing or not os.path.exists(
            os.path.join(args.cache, f"meta_{args.size}.json")):
        print(f"rendering {len(missing)} configuration(s) in a CPU+f64 "
              "subprocess...", flush=True)
        cmd = [sys.executable, os.path.abspath(__file__), "--phase",
               "render", "--size", str(args.size), "--cache", args.cache,
               "--sweeps", *args.sweeps]
        if args.gammas:
            cmd += ["--gammas", args.gammas]
        subprocess.run(cmd, check=True)
    phase_eval(args)


if __name__ == "__main__":
    main()
