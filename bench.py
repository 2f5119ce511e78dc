"""Benchmark: full-HD RS frame-pair throughput on one GPU.

Prints two JSON lines, each naming the device it ran on:

  rs_sfm_fullhd_e2e_pairs_per_s_per_chip — the production path: dense flow
      (forward + backward + FB occlusion) -> 256-hypothesis RANSAC ->
      4-start winnowed 20-iteration Huber Schur-LM -> 2 model-feedback
      passes -> rectification (config.PRODUCTION_CONFIG, the variational
      flow preset);
  rs_sfm_fullhd_pairs_per_s_per_chip — the solver path on a given flow
      field: RANSAC -> 20-iteration Schur-LM -> rectification.

Timing: each step is one jitted call; the value is 1 / the median of 5
calls with distinct PRNG keys, each ended by block_until_ready (all five
are printed).  Compilation and peak device memory are reported apart from
the timed window.  A run without a GPU, or on a GPU missing from PEAKS,
fails.

Baseline: the reference's laptop figures at full-HD (report.pdf §5.5):
~160 s/pair end to end (30 s DeepFlow + 130 s solve) and ~130 s/pair for
the solver stages.  vs_baseline = our pairs/s over the reference's.

Options: --sor-engine {auto,xla} picks the flow solver's SOR path (auto =
the fused CUDA kernel); --trace DIR records a jax.profiler trace of three
e2e steps, with CUDA graphs off, and prints the device time per stage.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# Published peaks per device_kind (NVIDIA H100 SXM data sheet, dense, at
# the 700 W power limit): float32 outside the tensor cores, HBM bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}

H, W = 1080, 1920
GAMMA = 0.9


def peaks_for(device_kind: str) -> dict:
    """Peak rates of `device_kind`; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise RuntimeError(
            f"no peak rates for device {device_kind!r}; add it to "
            "bench.PEAKS with its data-sheet source") from None


def solver_flops_bytes(h, w, trials, iters):
    """Analytic FLOP/byte model of the solver path (per pair).

      * RANSAC scoring: per hypothesis x pixel — beta (~5), A·v/B·w + beta
        scaling (~22), residual (2), closed-form rho (7), predicted flow
        (4), error norm + compare (7), reductions (2) ≈ 50 FLOPs; the
        8-field f32 pixel record is read once per chunk of 32 hypotheses.
      * Schur-LM refinement: per iteration x pixel — pixel terms + 7x2
        Jacobian rows (~250), 8x8 Gram (128) and the Schur product (~110);
        ~8 f32 fields of traffic per iteration.
      * backprojection + depth raster + prepare: ~150 FLOPs/px, ~3 passes
        of ~24 B/px.
    """
    n = h * w
    score_f = 50.0 * trials * n
    score_b = 32.0 * n * max(1, trials // 32)
    refine_f = iters * n * (250.0 + 128.0 + 110.0)
    refine_b = iters * 32.0 * n
    misc_f = 150.0 * n
    misc_b = 3 * 24.0 * n
    return score_f + refine_f + misc_f, score_b + refine_b + misc_b


def device_info():
    """{platform, kind, count} of the GPU and nvidia-smi's name/power."""
    import jax

    from rs_sfm_tpu.utils.runtime import nvidia_smi_name_power, require_gpu

    dev = require_gpu()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": nvidia_smi_name_power()}


def synthetic_inputs():
    """A realistic full-HD RS flow field, a textured frame 1 and frame 2 =
    frame 1 resampled through that flow (timing is content-independent;
    this keeps the occlusion mask sparse like a real pair)."""
    import jax.numpy as jnp

    from __graft_entry__ import _make_flow
    from rs_sfm_tpu.flow.dense import _warp

    flow = jnp.asarray(_make_flow(H, W))
    image = jnp.asarray(np.random.default_rng(0).uniform(
        0.1, 0.9, (H, W, 3)).astype(np.float32))
    i1 = image[..., 0]
    return flow, image, i1, _warp(i1, flow)


def production_step(i1, i2, image, intr, gamma, flow_cfg, est_cfg, key):
    """The production path on one pair: FB flow + occlusion, estimation
    with feedback, per-scanline poses, rectification."""
    import jax.numpy as jnp

    from rs_sfm_tpu.flow.dense import flow_forward_backward
    from rs_sfm_tpu.geom.rspose import scanline_poses
    from rs_sfm_tpu.rectify.backproject import backproject
    from rs_sfm_tpu.solver.pipeline import estimate_with_feedback

    fb = flow_forward_backward(i1, i2, flow_cfg)
    res = estimate_with_feedback(fb.flow, intr, gamma, est_cfg, key,
                                 pixel_mask=~fb.occlusion)
    r, t = scanline_poses(res.v, res.w, res.k, i1.shape[0], gamma,
                          dtype=jnp.float32)
    rect = backproject(image, res.depth_map, r, t, intr)
    return fb, res, rect


def time_step(fn, args, n_iters=5):
    """(compile_s, median_s, all_s) of the jitted fn(*args, key): one
    compile, one warm-up call, then n_iters calls with distinct keys, each
    ended by block_until_ready."""
    import jax

    key0 = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args, key0).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args, key0))
    times = []
    for i in range(n_iters):
        key = jax.random.PRNGKey(i + 1)
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args, key))
        times.append(time.perf_counter() - t0)
    return compile_s, float(np.median(times)), times


def trace_stages(fn, args, log_dir, steps=3):
    """Trace `steps` calls of the jitted fn and reduce the trace to device
    ms per stage (utils.profiling.device_stage_times)."""
    import jax

    from rs_sfm_tpu.utils.profiling import device_stage_times

    jitted = jax.jit(fn)
    compiled = jitted.lower(*args, jax.random.PRNGKey(0)).compile()
    jax.block_until_ready(compiled(*args, jax.random.PRNGKey(0)))
    jax.profiler.start_trace(log_dir)
    try:
        for i in range(steps):
            jax.block_until_ready(compiled(*args, jax.random.PRNGKey(i)))
    finally:
        jax.profiler.stop_trace()
    out = device_stage_times(log_dir, [compiled.as_text()])
    out["steps"] = steps
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sor-engine", choices=("auto", "xla"),
                        default="auto")
    parser.add_argument("--trace", default=None, metavar="DIR")
    args = parser.parse_args(argv)
    if args.trace:
        # Kernels inside a CUDA graph show in the trace as one opaque
        # "command_buffer" event; launch them one by one so each keeps its
        # HLO op (times of single kernels are unchanged; gaps grow).
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax

    from rs_sfm_tpu.config import PRODUCTION_CONFIG, PipelineConfig
    from rs_sfm_tpu.geom.camera import Intrinsics
    from rs_sfm_tpu.geom.rspose import scanline_poses
    from rs_sfm_tpu.models import get_flow_preset
    from rs_sfm_tpu.rectify.backproject import backproject
    from rs_sfm_tpu.solver.pipeline import estimate_from_flow
    from rs_sfm_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    device = device_info()
    peaks = peaks_for(device["kind"])
    dev = jax.devices()[0]

    intr = Intrinsics(fx=1803.3, fy=1799.4, cx=945.3, cy=544.7)
    flow, image, i1, i2 = synthetic_inputs()
    flow_cfg = get_flow_preset("variational", sor_engine=args.sor_engine)

    def e2e(a, b, img, key):
        _, res, rect = production_step(a, b, img, intr, GAMMA, flow_cfg,
                                       PRODUCTION_CONFIG, key)
        return res.v.sum() + rect.gs_image.sum()

    if args.trace:
        stages = trace_stages(e2e, (i1, i2, image), args.trace)
        print(json.dumps({"trace": args.trace, "sor_engine": args.sor_engine,
                          **stages, "device": device}))
        return 0

    # Solver path on the given flow: 20 LM iterations with a static trip
    # count (VarPro re-eliminates the depths in closed form each step and
    # converges in ~10).
    cfg = PipelineConfig(ransac_trials=256, ransac_chunk=32,
                         refine_iterations=20, refine_rel_tol=0.0)

    def solver(f, img, key):
        res = estimate_from_flow(f, intr, GAMMA, cfg, key)
        r, t = scanline_poses(res.v, res.w, res.k, H, GAMMA,
                              dtype=f.dtype)
        rect = backproject(img, res.depth_map, r, t, intr)
        return res.v.sum() + res.depth_map.sum() + rect.gs_image.sum()

    compile_e, dt_e, times_e = time_step(e2e, (i1, i2, image))
    compile_s, dt_s, times_s = time_step(solver, (flow, image))
    peak_mem = (dev.memory_stats() or {}).get("peak_bytes_in_use")

    common = {"device": device, "sor_engine": args.sor_engine,
              "peak_bytes_in_use": peak_mem}
    print(json.dumps({
        "metric": "rs_sfm_fullhd_e2e_pairs_per_s_per_chip",
        "value": 1.0 / dt_e,
        "unit": "frame-pairs/s (1920x1080 production path: FB dense flow "
                "+ occlusion, 256-hypothesis RANSAC, 4-start winnowed "
                "20-iter Huber Schur-LM, 2 feedback passes, rectify)",
        "vs_baseline": 160.0 / dt_e,
        "s_per_pair": times_e, "compile_s": compile_e, **common}))
    flops, bytes_ = solver_flops_bytes(H, W, cfg.ransac_trials,
                                       cfg.refine_iterations)
    print(json.dumps({
        "metric": "rs_sfm_fullhd_pairs_per_s_per_chip",
        "value": 1.0 / dt_s,
        "unit": "frame-pairs/s (1920x1080 solver path on given flow: "
                "256-hypothesis RANSAC, 20-iter Schur-LM, rectify)",
        "vs_baseline": 130.0 / dt_s,
        "s_per_pair": times_s, "compile_s": compile_s,
        # Analytic model over the published peaks (fp32 outside the
        # tensor cores; HBM), at the card's power limit shown in device.
        "fp32_peak_share": flops / dt_s / peaks["fp32_flops"],
        "hbm_peak_share": bytes_ / dt_s / peaks["hbm_bytes_s"],
        "model_gflop_per_pair": flops / 1e9,
        "model_gb_per_pair": bytes_ / 1e9,
        **common}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
