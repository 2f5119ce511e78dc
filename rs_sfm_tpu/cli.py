"""Command-line interface.

Replaces the reference's comment-toggled main() entry points
(src/main.cc:133-142) with real subcommands:

  generate    render synthetic RS datasets (replaces the MATLAB pipeline)
  single-run  end-to-end single pair + artifacts (evaluateSingleRun,
              src/main.cc:302-559)
  sweep       task-list evaluation harness + result CSVs
              (evaluateParameterSweep, src/main.cc:148-299)
  bench       JSON-line GPU benchmark (same as bench.py)

Examples:
  python -m rs_sfm_tpu.cli generate --out /tmp/ds --size 128 --gamma 0.9
  python -m rs_sfm_tpu.cli single-run --data /tmp/ds --out /tmp/results
  python -m rs_sfm_tpu.cli sweep --path /tmp/sweep
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

import numpy as np


def _setup_jax(args):
    import jax

    from rs_sfm_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    return jax


def _add_common(p):
    p.add_argument("--platform", default=None,
                   help="jax platform override (cpu/gpu)")
    p.add_argument("--x64", action="store_true",
                   help="enable float64 (recommended on CPU)")


def cmd_generate(args):
    jax = _setup_jax(args)
    import jax.numpy as jnp

    from rs_sfm_tpu.data.dataset import save_synthetic_pair
    from rs_sfm_tpu.data.synthetic import (castle_scene, default_intrinsics,
                                           render_pair)

    dtype = jnp.float64 if args.x64 else jnp.float32
    scene = castle_scene(dtype=dtype)
    h = w = args.size
    intr = default_intrinsics(h, w)
    v = np.asarray([float(x) for x in args.v.split(",")])
    w_rot = np.asarray([float(x) for x in args.w.split(",")])
    pair = render_pair(scene, intr, h, w, gamma=args.gamma, k=args.k,
                       v=v, w=w_rot, dtype=dtype)
    prefix = save_synthetic_pair(pair, args.out)
    print(f"wrote dataset to {args.out} (images under {prefix})")


def cmd_generate_sweep(args):
    """Render a parameter-sweep dataset (replaces the MATLAB castle.m sweep
    driver, matlab_synthetic_data/castle.m:11-30): one task directory per
    parameter combination + tasks.txt."""
    jax = _setup_jax(args)
    import jax.numpy as jnp

    from rs_sfm_tpu.data.dataset import save_synthetic_pair
    from rs_sfm_tpu.data.synthetic import (castle_scene, default_intrinsics,
                                           render_pair)

    dtype = jnp.float64 if args.x64 else jnp.float32
    scene = castle_scene(dtype=dtype)
    h = w = args.size
    intr = default_intrinsics(h, w)
    gammas = [float(x) for x in args.gammas.split(",")]
    ks = [float(x) for x in args.ks.split(",")]
    vs = [float(x) for x in args.vs.split(",")]
    ws = [float(x) for x in args.ws.split(",")]
    # Mean scene depth scaling of |v| (start_generating.m:56-58) with the
    # castle proxy's ~6-unit mean depth.
    mean_depth = 6.0
    tasks = []
    for g in gammas:
        for k in ks:
            for vmag in vs:
                for wmag in ws:
                    name = f"g{g}_k{k}_v{vmag}_w{wmag}"
                    v_vec = jnp.asarray([vmag, vmag, 0.0]) * mean_depth
                    w_vec = jnp.asarray([0.0, 0.0, wmag])
                    pair = render_pair(scene, intr, h, w, gamma=g, k=k,
                                       v=v_vec, w=w_vec, dtype=dtype)
                    save_synthetic_pair(pair, os.path.join(args.out, name))
                    tasks.append(name)
                    print("rendered", name)
    with open(os.path.join(args.out, "tasks.txt"), "w") as f:
        f.write("\n".join(tasks) + "\n")
    print(f"{len(tasks)} task(s) under {args.out}")


def cmd_single_run(args):
    jax = _setup_jax(args)
    import jax.numpy as jnp

    from rs_sfm_tpu.config import PipelineConfig
    from rs_sfm_tpu.data import intrinsics as intr_registry
    from rs_sfm_tpu.data.dataset import (load_real_pair, load_synthetic_pair,
                                         true_depth_from_unprojection)
    from rs_sfm_tpu.eval import artifacts
    from rs_sfm_tpu.eval.harness import compute_flow
    from rs_sfm_tpu.eval.metrics import mean_reprojection_error
    from rs_sfm_tpu.geom.rspose import scanline_poses
    from rs_sfm_tpu.rectify.backproject import backproject
    from rs_sfm_tpu.rectify.crackfill import fill_cracks
    from rs_sfm_tpu.solver.pipeline import estimate_with_feedback

    dtype = jnp.float64 if args.x64 else jnp.float32
    if args.camera:
        pair = load_real_pair(args.data, intr_registry.get(args.camera))
        use_flow = True
    else:
        pair = load_synthetic_pair(args.data)
        use_flow = args.deep_flow

    cfg = PipelineConfig(
        ransac_trials=args.ransac_trials, ransac_tol=args.ransac_tol,
        use_acceleration=args.acceleration,
        use_global_shutter=args.global_shutter,
        use_refinement=not args.no_refinement,
        refine_starts=args.refine_starts)
    gamma = args.gamma if args.gamma is not None else (pair.gamma or 0.9)

    from rs_sfm_tpu.models import resolve_flow_preset

    def unit_img(img):
        arr = jnp.asarray(img, dtype=jnp.float32)
        return arr / 255.0 if np.asarray(img).dtype == np.uint8 else arr

    flow_cfg, resolved = resolve_flow_preset(
        args.flow_model,
        unit_img(pair.frame1.rs_image) if args.flow_model == "auto" else None,
        unit_img(pair.frame2.rs_image) if args.flow_model == "auto" else None)
    if args.flow_model == "auto":
        print(f"flow model auto -> {resolved}")
    if args.census_weight is not None:
        flow_cfg = flow_cfg._replace(census_weight=args.census_weight)
    pixel_mask = None
    if use_flow and args.occlusion_mask:
        from rs_sfm_tpu.flow.dense import flow_forward_backward

        def unit(img):
            arr = jnp.asarray(img, dtype=jnp.float32)
            return arr / 255.0 if np.asarray(img).dtype == np.uint8 else arr

        fb = flow_forward_backward(unit(pair.frame1.rs_image),
                                   unit(pair.frame2.rs_image), flow_cfg)
        flow_px = jnp.asarray(fb.flow, dtype)
        pixel_mask = ~fb.occlusion
        print(f"occlusion-masked pixels: {float(fb.occlusion.mean()):.1%}")
    else:
        flow_px = compute_flow(pair, use_flow, dtype=dtype,
                               flow_cfg=flow_cfg)
    if use_flow and args.model_feedback:
        # Model-feedback pass(es) (flow/feedback.py, promoted to the
        # config in r5): tight-consensus + depth-coherence outliers
        # extend the mask; the re-estimation runs per
        # cfg.feedback_mode (measured r4: err_v 0.127 -> 0.104 on the
        # photometric full-HD stress scene).
        import dataclasses

        cfg = dataclasses.replace(cfg, feedback_passes=2,
                                  feedback_refine_iterations=8)
    res = estimate_with_feedback(flow_px, pair.intrinsics, gamma, cfg,
                                 jax.random.PRNGKey(args.seed),
                                 pixel_mask=pixel_mask)
    print("num_inliers:", int(res.num_inliers))
    print("w:", np.asarray(res.w))
    print("v:", np.asarray(res.v))
    print("k:", float(res.k))

    h = flow_px.shape[0]
    r_sl, t_sl = scanline_poses(res.v, res.w, res.k, h, gamma, dtype=dtype)
    rs_img = jnp.asarray(pair.frame1.rs_image)
    rect = backproject(rs_img, res.depth_map, r_sl, t_sl, pair.intrinsics)
    gs = fill_cracks(fill_cracks(rect.gs_image, offset=1), offset=2)

    out_dir = args.out or os.path.join(args.data, "results")
    artifacts.save_single_run_artifacts(
        out_dir, flow_px=np.asarray(flow_px), rs_image=pair.frame1.rs_image,
        depth_map=res.depth_map, gs_image=gs, coords_3d=rect.coords_3d,
        valid=rect.valid)
    import json

    with open(os.path.join(out_dir, "estimate.json"), "w") as f:
        json.dump({"v": np.asarray(res.v).tolist(),
                   "w": np.asarray(res.w).tolist(),
                   "k": float(res.k), "gamma": float(gamma),
                   "num_inliers": int(res.num_inliers)}, f, indent=1)
    print(f"artifacts written to {out_dir}")

    if pair.frame1.rs_unproject is not None:
        td = jnp.asarray(true_depth_from_unprojection(
            pair.frame1.rs_unproject, pair.frame1.poses_r,
            pair.frame1.poses_t), dtype=dtype)
        err3d, scale, true3d = mean_reprojection_error(
            rect.coords_3d, rect.valid, td,
            jnp.asarray(pair.frame1.poses_r, dtype=dtype),
            jnp.asarray(pair.frame1.poses_t, dtype=dtype), pair.intrinsics)
        print("mean reprojection error:", float(err3d),
              " (scale", float(scale), ")")
        artifacts.imwrite(
            os.path.join(out_dir, "error_image.png"),
            artifacts.error_image(rect.coords_3d, true3d, rect.valid))
        if pair.frame1.gs_image is not None:
            # Synthetic-only difference/remainder/overlay set
            # (reference src/main.cc:533-556).
            for name, img in artifacts.synthetic_eval_images(
                    pair.frame1.rs_image, pair.frame1.gs_image, gs).items():
                artifacts.imwrite(os.path.join(out_dir, name), img)


def cmd_sweep(args):
    jax = _setup_jax(args)

    from rs_sfm_tpu.config import PipelineConfig
    from rs_sfm_tpu.data.dataset import load_synthetic_pair
    from rs_sfm_tpu.eval.harness import evaluate_velocities

    path = args.path
    with open(os.path.join(path, "tasks.txt")) as f:
        tasks = [line.strip() for line in f if line.strip()]

    # Checkpoint/resume: --resume continues an existing results dir, skipping
    # tasks recorded in its progress file (the reference's only resume story
    # is skipping already-rendered data dirs on the MATLAB side,
    # start_generating.m:33-36).
    done: set = set()
    if args.resume:
        results_dir = args.resume
        progress_path = os.path.join(results_dir, "progress.json")
        if os.path.exists(progress_path):
            with open(progress_path) as f:
                done = set(json.load(f)["done"])
        print(f"resuming {results_dir}: {len(done)} task(s) already done")
    else:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        results_dir = os.path.join(path, "results", stamp)
    os.makedirs(results_dir, exist_ok=True)
    progress_path = os.path.join(results_dir, "progress.json")

    cfg = PipelineConfig(
        ransac_trials=args.ransac_trials, ransac_tol=args.ransac_tol,
        use_acceleration=args.acceleration,
        use_global_shutter=args.global_shutter,
        use_refinement=not args.no_refinement,
        refine_starts=args.refine_starts)

    with open(os.path.join(results_dir, "configuration"), "w") as f:
        f.write(f"ransac trials: {cfg.ransac_trials}\n"
                f"evaluation runs: {args.num_evaluations}\n"
                f"use deep flow: {int(args.deep_flow)}\n"
                f"use GS assumption: {int(cfg.use_global_shutter)}\n"
                f"use const acceleration: {int(cfg.use_acceleration)}\n"
                f"use refinement: {int(cfg.use_refinement)}\n"
                f"refine starts: {cfg.refine_starts}\n"
                + "-" * 46 + "\n" + "\n".join(tasks) + "\n")

    mode = "a" if args.resume else "w"
    files = {name: open(os.path.join(results_dir, name + ".csv"), mode)
             for name in ["w", "v", "k", "reproject_errors", "error_v",
                          "error_w"]}
    errors_f = open(os.path.join(results_dir, "errors.csv"), mode)
    if not args.resume:
        errors_f.write("task,error_w,error_v,reproject_error\n")

    for i, task in enumerate(tasks):
        if task in done:
            print(f"\nSkipping {task} (already done)")
            continue
        print(f"\nExecuting task {task}...")
        pair = load_synthetic_pair(os.path.join(path, task))
        image_path = os.path.join(results_dir, "depthMaps", str(i))
        from rs_sfm_tpu.models import resolve_flow_preset

        import numpy as _np

        def _unit(img):
            import jax.numpy as jnp

            arr = jnp.asarray(img, dtype=jnp.float32)
            return arr / 255.0 if _np.asarray(img).dtype == _np.uint8 \
                else arr

        flow_cfg, resolved = resolve_flow_preset(
            args.flow_model,
            _unit(pair.frame1.rs_image) if args.flow_model == "auto"
            else None,
            _unit(pair.frame2.rs_image) if args.flow_model == "auto"
            else None)
        if args.flow_model == "auto":
            print(f"  flow model auto -> {resolved}")
        if args.census_weight is not None:
            flow_cfg = flow_cfg._replace(census_weight=args.census_weight)
        errs = evaluate_velocities(
            pair, cfg, num_evaluations=args.num_evaluations,
            use_deep_flow=args.deep_flow,
            key=jax.random.PRNGKey(args.seed + i), image_path=image_path,
            flow_cfg=flow_cfg, use_occlusion_mask=args.occlusion_mask)
        errors_f.write(f"{task},{errs.error_w},{errs.error_v},"
                       f"{errs.error_reproject}\n")
        n = errs.k.shape[0]
        files["w"].write(",".join(
            " ".join(map(str, errs.w[:, j])) for j in range(n)) + "\n")
        files["v"].write(",".join(
            " ".join(map(str, errs.v[:, j])) for j in range(n)) + "\n")
        files["k"].write(",".join(map(str, errs.k)) + "\n")
        files["reproject_errors"].write(
            ",".join(map(str, errs.error_reproject_vec)) + "\n")
        files["error_v"].write(",".join(map(str, errs.error_v_vec)) + "\n")
        files["error_w"].write(",".join(map(str, errs.error_w_vec)) + "\n")
        print(f"  error_w={errs.error_w:.6f} error_v={errs.error_v:.6f} "
              f"reproject={errs.error_reproject:.4f}")
        done.add(task)
        for f in files.values():
            f.flush()
        errors_f.flush()
        with open(progress_path, "w") as f:
            json.dump({"done": sorted(done)}, f)

    for f in files.values():
        f.close()
    errors_f.close()
    print(f"\nresults written to {results_dir}")


def cmd_test_flow(args):
    """Flow self-check (the reference's testFlow, src/main.cc:563-609, as an
    assertable metric instead of an imshow diff)."""
    jax = _setup_jax(args)
    import jax.numpy as jnp

    from rs_sfm_tpu.data.dataset import load_synthetic_pair
    from rs_sfm_tpu.eval.harness import compute_flow
    from rs_sfm_tpu.flow.check import flow_consistency_error

    dtype = jnp.float64 if args.x64 else jnp.float32
    pair = load_synthetic_pair(args.data)
    i1 = jnp.asarray(pair.frame1.rs_image, dtype) / 255.0
    i2 = jnp.asarray(pair.frame2.rs_image, dtype) / 255.0
    for name, deep in [("true", False), ("dense", True)]:
        try:
            flow = compute_flow(pair, deep, dtype=dtype)
        except ValueError:
            continue
        err = float(flow_consistency_error(i1, i2, flow))
        base = float(flow_consistency_error(i1, i2, jnp.zeros_like(flow)))
        verdict = "OK" if err < 0.7 * base else "SUSPECT"
        print(f"{name} flow: warp error {err:.4f} (no-flow baseline "
              f"{base:.4f}) -> {verdict}")


def cmd_bench(args):
    del args
    import bench

    return bench.main([])


def main(argv=None):
    parser = argparse.ArgumentParser(prog="rs_sfm_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="render a synthetic RS dataset")
    g.add_argument("--out", required=True)
    g.add_argument("--size", type=int, default=128)
    g.add_argument("--gamma", type=float, default=0.9)
    g.add_argument("--k", type=float, default=0.0)
    g.add_argument("--v", default="0.12,-0.05,0.08")
    g.add_argument("--w", default="0.003,-0.002,0.004")
    _add_common(g)
    g.set_defaults(fn=cmd_generate)

    gs = sub.add_parser("generate-sweep",
                        help="render a parameter-sweep dataset grid")
    gs.add_argument("--out", required=True)
    gs.add_argument("--size", type=int, default=128)
    gs.add_argument("--gammas", default="0.1,0.5,0.9")
    gs.add_argument("--ks", default="0")
    gs.add_argument("--vs", default="0.02")
    gs.add_argument("--ws", default="0.001")
    _add_common(gs)
    gs.set_defaults(fn=cmd_generate_sweep)

    def add_est_flags(p):
        p.add_argument("--ransac-trials", type=int, default=256)
        p.add_argument("--ransac-tol", type=float, default=0.05)
        p.add_argument("--refine-starts", type=int, default=1,
                       help="multi-start refinement (top-J RANSAC "
                            "hypotheses; 4 recommended on estimated flow)")
        p.add_argument("--acceleration", action="store_true")
        p.add_argument("--global-shutter", action="store_true")
        p.add_argument("--no-refinement", action="store_true")
        p.add_argument("--deep-flow", action="store_true")
        p.add_argument("--flow-model", default="variational",
                       help="dense-flow preset from rs_sfm_tpu.models "
                            "(variational / fast / robust / census / "
                            "auto — auto probes the pair at coarse scale "
                            "and picks plain vs robust per pair)")
        p.add_argument("--census-weight", type=float, default=None,
                       help="ternary-census data term weight (real imagery "
                            "with illumination changes; 0 = off; overrides "
                            "the flow-model preset, including explicit 0)")
        p.add_argument("--occlusion-mask", action="store_true",
                       help="forward-backward occlusion check; occluded "
                            "pixels are excluded from RANSAC/refinement")
        p.add_argument("--model-feedback", action="store_true",
                       help="model-feedback re-estimation passes on the "
                            "trusted mask (tight-consensus + "
                            "depth-coherence outliers excluded; 2 "
                            "passes, the r5 production setting — "
                            "flow/feedback.py)")
        p.add_argument("--gamma", type=float, default=None)
        p.add_argument("--seed", type=int, default=0)
        _add_common(p)

    s = sub.add_parser("single-run", help="end-to-end single pair")
    s.add_argument("--data", required=True)
    s.add_argument("--out", default=None)
    s.add_argument("--camera", default=None,
                   help="named intrinsics for real pairs (frame{1,2}.png)")
    add_est_flags(s)
    s.set_defaults(fn=cmd_single_run)

    sw = sub.add_parser("sweep", help="task-list evaluation harness")
    sw.add_argument("--path", required=True)
    sw.add_argument("--num-evaluations", type=int, default=2)
    sw.add_argument("--resume", default=None,
                    help="existing results dir to continue")
    add_est_flags(sw)
    sw.set_defaults(fn=cmd_sweep)

    tf = sub.add_parser("test-flow", help="flow warp self-check")
    tf.add_argument("--data", required=True)
    _add_common(tf)
    tf.set_defaults(fn=cmd_test_flow)

    b = sub.add_parser("bench", help="JSON-line GPU benchmark")
    _add_common(b)
    b.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
