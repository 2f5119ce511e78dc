"""Smoke test of the production path on one GPU (or, with --multi-gpu,
of the two sharded paths on four).

  python chip_smoke.py              # one card: phases 1-5 below
  python chip_smoke.py --multi-gpu  # four cards: DP over pairs and
                                    # scanline-block sharding of one pair

Phases (any failure raises, and the exit code is non-zero):
  1. device: JAX's first device must be a GPU; prints its kind and
     nvidia-smi's name and power limit.
  2. entry points: `rs_sfm_tpu.cli generate --size 1080`, then
     `single-run --deep-flow --occlusion-mask --model-feedback
     --refine-starts 4 --flow-model auto` in a child process; its
     artifacts and a finite reprojection error against the ground truth.
  3. full-HD production step (1080x1920, config.PRODUCTION_CONFIG) on the
     clean castle pair (variational preset) and the photometric pair
     (robust preset), held to tests/test_fullhd_flow.py's gates; prints
     compile time, seconds per pair and peak device memory.
  4. the fused SOR kernel against the XLA loop at every full-HD pyramid
     level, after one launch and after a warp's 20 sweeps: max |du|, |dv|
     <= 1e-2 px (see phase_sor), with both times.
  5. geometry precision: rectification coordinates and the exact RS flow
     on the GPU against the same jitted call in a CPU-only child process
     (<= 1e-3 px, or 16 float32 ulps of the coordinate where that is
     larger).

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Only one process uses the card at a time: the parent does not preallocate
device memory, and it waits, off the card, while the CLI child runs; the
geometry child runs on the CPU only.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

# Before JAX starts: allocate on demand, so the CLI child of phase 2 can
# take its share of the card.
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

H, W = 1080, 1920
GAMMA = 0.9
V_TRUE = np.array([0.35, -0.15, 0.25])
W_TRUE = np.array([0.003, -0.002, 0.004])
# (preset, photometric corruption, gates: median EPE px, err_v rad, err3d,
# depth RMSE) — tests/test_fullhd_flow.py.
CASES = (("variational", False, (0.3, 0.04, 0.35, 0.9)),
         ("robust", True, (3.5, 0.12, 1.0, 2.2)))
HERE = os.path.dirname(os.path.abspath(__file__))
# Bound on the fused SOR kernel's difference from the XLA loop (phase_sor).
SOR_TOL_PX = 1e-2
GEOMETRY_INPUTS = ("image", "depth", "unproj", "poses_r", "poses_t")


def log(*args):
    print(*args, flush=True)


def phase_device():
    from rs_sfm_tpu.utils.runtime import (nvidia_smi_name_power,
                                          require_gpu, setup_compile_cache)

    dev = require_gpu()
    cache = setup_compile_cache()
    log(f"[device] {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"compile cache {cache}")
    log(f"[device] nvidia-smi: {nvidia_smi_name_power()}")
    return dev


def phase_cli(size=1080):
    """The normal entry points, in a child process on the GPU."""
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_cli_") as tmp:
        data = os.path.join(tmp, "pair")
        out = os.path.join(tmp, "results")
        cmds = [
            ["generate", "--out", data, "--size", str(size)],
            ["single-run", "--data", data, "--out", out, "--deep-flow",
             "--occlusion-mask", "--model-feedback", "--refine-starts", "4",
             "--flow-model", "auto"],
        ]
        env = dict(os.environ)
        env.pop("XLA_PYTHON_CLIENT_PREALLOCATE", None)
        for args in cmds:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "rs_sfm_tpu.cli"]
                               + args, cwd=HERE, env=env, text=True,
                               capture_output=True, timeout=900)
            log(f"[cli] {args[0]}: rc {r.returncode} in "
                f"{time.perf_counter() - t0:.1f} s")
            if r.returncode != 0:
                raise RuntimeError(f"cli {args[0]} failed:\n"
                                   f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        err_lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("mean reprojection error:")]
        if not err_lines:
            raise RuntimeError("single-run printed no reprojection error:\n"
                               + r.stdout[-3000:])
        err3d = float(err_lines[-1].split(":")[1].split()[0])
        if not np.isfinite(err3d):
            raise RuntimeError(f"reprojection error is {err3d}")
        made = set(os.listdir(out))
        need = {"estimate.json", "point_cloud.ply", "optical_flow.png",
                "optical_flow_arrow.png", "MinimalDepth.png",
                "backprojection.png", "error_image.png"}
        if not need <= made:
            raise RuntimeError(f"missing artifacts: {sorted(need - made)}")
        with open(os.path.join(out, "estimate.json")) as f:
            est = json.load(f)
        if not np.all(np.isfinite(est["v"] + est["w"])):
            raise RuntimeError(f"non-finite estimate {est}")
        log(f"[cli] {size}x{size} single-run ok: mean reprojection error "
            f"{err3d:.4f}, {est['num_inliers']} inliers, "
            f"{len(made)} artifacts")


def render_castle(h=H, w=W):
    """The clean full-HD castle pair with its ground truth (f32)."""
    from rs_sfm_tpu.data.dataset import true_depth_from_unprojection
    from rs_sfm_tpu.data.synthetic import (castle_scene, default_intrinsics,
                                           render_pair)
    from rs_sfm_tpu.flow.true_flow import true_flow

    intr = default_intrinsics(h, w)
    pair = render_pair(castle_scene(dtype=jnp.float32), intr, h, w,
                       gamma=GAMMA, k=0.0, v=V_TRUE, w=W_TRUE,
                       dtype=jnp.float32)
    gt = np.asarray(true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                              pair.frame2.poses_t, intr))
    td = true_depth_from_unprojection(np.asarray(pair.frame1.rs_unproject),
                                      np.asarray(pair.frame1.poses_r),
                                      np.asarray(pair.frame1.poses_t))
    return intr, pair, gt, jnp.asarray(td, jnp.float32)


def production_fn(intr, flow_cfg):
    """The jitted full-HD production step for one flow preset."""
    from bench import production_step
    from rs_sfm_tpu.config import PRODUCTION_CONFIG

    @jax.jit
    def step(a, b, key):
        fb, res, rect = production_step(a, b, a, intr, GAMMA, flow_cfg,
                                        PRODUCTION_CONFIG, key)
        return (fb.flow, res.v, res.depth_map, res.inlier_mask,
                rect.coords_3d, rect.valid)

    return step


def phase_fullhd(dev, intr, pair, gt, td):
    from rs_sfm_tpu.data.synthetic import apply_photometric
    from rs_sfm_tpu.eval.metrics import (depth_rmse, mean_reprojection_error,
                                         translation_error)
    from rs_sfm_tpu.models import get_flow_preset

    i1 = jnp.asarray(pair.frame1.rs_image, jnp.float32)
    poses_r = jnp.asarray(pair.frame1.poses_r, jnp.float32)
    poses_t = jnp.asarray(pair.frame1.poses_t, jnp.float32)
    moving = np.linalg.norm(gt, axis=-1) > 0
    key = jax.random.PRNGKey(0)
    jobs = []
    for preset, photometric, gates in CASES:
        i2 = jnp.asarray(pair.frame2.rs_image, jnp.float32)
        if photometric:
            i2 = jnp.asarray(apply_photometric(
                i2, jax.random.PRNGKey(1), exposure=1.35, vignette=0.35,
                noise_sigma=0.005), jnp.float32)
        jobs.append((preset, photometric, gates, i2,
                     production_fn(intr, get_flow_preset(preset))))
    # The presets' programs compile concurrently (XLA compiles off the GIL).
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        compiled = list(pool.map(
            lambda job: job[4].lower(i1, job[3], key).compile(), jobs))
    log(f"[fullhd] compiled the {len(jobs)} presets' steps concurrently in "
        f"{time.perf_counter() - t0:.1f} s")
    fb_clean = None
    for (preset, photometric, gates, i2, _), step in zip(jobs, compiled):
        flow, v, depth, inl, coords, valid = jax.block_until_ready(
            step(i1, i2, key))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(step(i1, i2, key))
            times.append(time.perf_counter() - t0)
        err3d, _, _ = mean_reprojection_error(coords, valid, td, poses_r,
                                              poses_t, intr)
        drmse, _ = depth_rmse(depth, td, inl)
        flow = np.asarray(flow)
        epe = float(np.median(np.linalg.norm(flow - gt, axis=-1)[moving]))
        err_v = float(translation_error(v, jnp.asarray(V_TRUE, jnp.float32)))
        got = (epe, err_v, float(err3d), float(drmse))
        names = ("median EPE px", "err_v rad", "err3d", "depth RMSE")
        log(f"[fullhd] {preset}{' photometric' if photometric else ''}: "
            + ", ".join(f"{n} {g:.4f} (<= {t})"
                        for n, g, t in zip(names, got, gates)))
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
        log(f"[fullhd] {preset}: {np.median(times):.4f} s/pair (median of "
            f"5; {' '.join(f'{t:.4f}' for t in times)}), peak device memory "
            f"{peak / 2**30:.2f} GiB")
        bad = [n for n, g, t in zip(names, got, gates)
               if not np.isfinite(g) or g > t]
        if bad:
            raise RuntimeError(f"{preset}: gates failed: {bad} {got}")
        if fb_clean is None:
            fb_clean = flow
    return fb_clean


def pyramid_problems(i1, i2, flow):
    """The SOR problem of every full-HD pyramid level, linearised around
    the estimated flow brought down to that level."""
    from rs_sfm_tpu.flow.dense import (_downsample, _linearise, _to_gray,
                                       _warp)

    p1, p2 = [_to_gray(i1)], [_to_gray(i2)]
    flows = [flow]
    while min(p1[-1].shape) >= 24 and len(p1) < 6:
        p1.append(_downsample(p1[-1]))
        p2.append(_downsample(p2[-1]))
        f = flows[-1]
        flows.append(jnp.stack([_downsample(f[..., 0]),
                                _downsample(f[..., 1])], -1) * 0.5)
    return [_linearise(a, _warp(b, f), f) for a, b, f in zip(p1, p2, flows)]


def phase_sor(pair, flow):
    """The fused SOR kernel against the XLA loop at every full-HD level.

    The point solve re-weights every pixel by the Charbonnier factor
    1/sqrt(r^2 + eps^2), eps = 1e-3, on each half-sweep, so one rounding
    of difference moves u by up to ~1e-3 px at full HD: the XLA loop
    differs from itself that much when its start flow moves by one ulp
    (printed beside each comparison).  A fault of the tile schedule (halo,
    colour, boundary) instead shifts whole tile borders by the size of a
    sweep's update, up to ~15 px on these problems.  The bound, SOR_TOL_PX
    on max |du|, |dv| after one launch and after a warp's sweeps, lies
    between the two."""
    from rs_sfm_tpu.flow.dense import DenseFlowConfig, sor_sweeps_xla
    from rs_sfm_tpu.ops import sor_cuda

    cfg = DenseFlowConfig()
    iters = cfg.iters

    def absdiff(a, b):
        return np.maximum(*(np.abs(np.asarray(x) - np.asarray(y))
                            for x, y in zip(a, b)))

    xla = jax.jit(lambda t, n: sor_sweeps_xla(t, n, cfg),
                  static_argnums=1)
    kern = jax.jit(lambda t, n: sor_cuda.sor_sweeps(t, n, cfg),
                   static_argnums=1)
    probs = pyramid_problems(jnp.asarray(pair.frame1.rs_image, jnp.float32),
                             jnp.asarray(pair.frame2.rs_image, jnp.float32),
                             jnp.asarray(flow))
    inf = jnp.float32(jnp.inf)
    for lin in probs:
        ulp = lin._replace(u0=jnp.nextafter(lin.u0, inf),
                           v0=jnp.nextafter(lin.v0, inf))
        row = []
        for n in (sor_cuda.TILE_SWEEPS, iters):
            ref = xla(lin, n)
            d = absdiff(ref, kern(lin, n))
            d_self = float(absdiff(ref, xla(ulp, n)).max())
            moved = float(np.abs(np.asarray(ref[0] - lin.u0)).max())
            dmax = float(d.max())
            row.append(f"{n} sweeps (u moved up to {moved:.2f}): max |d| "
                       f"{dmax:.2e} px, p99.9 {np.quantile(d, 0.999):.2e}, "
                       f"{int((d > 1e-3).sum())} px above 1e-3 (XLA vs "
                       f"itself from a 1-ulp start: {d_self:.2e})")
            if not dmax <= SOR_TOL_PX:
                raise RuntimeError(f"SOR kernel differs from the XLA loop by "
                                   f"{dmax} px after {n} sweeps at "
                                   f"{lin.u0.shape}")
        ms = {}
        for name, fn in (("xla", xla), ("kernel", kern)):
            t = []
            for _ in range(20):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(lin, iters))
                t.append(time.perf_counter() - t0)
            ms[name] = 1e3 * float(np.median(t))
        log(f"[sor] {lin.u0.shape[0]}x{lin.u0.shape[1]}: " + "; ".join(row)
            + f"; {iters} sweeps: XLA loop {ms['xla']:.3f} ms, kernel "
            f"{ms['kernel']:.3f} ms (median of 20)")


def geometry(arrays):
    """Rectification pixel coordinates, their valid mask and the exact RS
    flow of the pair in `arrays` (host arrays, GEOMETRY_INPUTS), jitted on
    JAX's default backend."""
    from rs_sfm_tpu.data.synthetic import default_intrinsics
    from rs_sfm_tpu.flow.true_flow import true_flow
    from rs_sfm_tpu.geom.camera import space_to_plane
    from rs_sfm_tpu.geom.rspose import scanline_poses
    from rs_sfm_tpu.rectify.backproject import backproject

    image, depth, unproj, p2r, p2t = (jnp.asarray(arrays[k])
                                      for k in GEOMETRY_INPUTS)
    intr = default_intrinsics(*depth.shape)

    @jax.jit
    def run(image, depth, unproj, p2r, p2t):
        r, t = scanline_poses(jnp.asarray(V_TRUE, jnp.float32),
                              jnp.asarray(W_TRUE, jnp.float32),
                              jnp.float32(0.0), depth.shape[0], GAMMA,
                              dtype=jnp.float32)
        rect = backproject(image, depth, r, t, intr)
        return (space_to_plane(rect.coords_3d, intr), rect.valid,
                true_flow(unproj, p2r, p2t, intr))

    return [np.asarray(a) for a in run(image, depth, unproj, p2r, p2t)]


def geometry_file(src, dst):
    """geometry() of the arrays in the .npz `src`, saved to `dst` (the
    CPU child of phase_geometry)."""
    with np.load(src) as f:
        px, valid, flow = geometry({k: f[k] for k in f.files})
    np.savez(dst, px=px, valid=valid, flow=flow)


def phase_geometry(pair, td):
    """The GPU against the CPU backend on the same inputs, in pixels.

    The CPU side runs in a child process with JAX_PLATFORMS=cpu, whatever
    platforms this process was given.  Per pixel the bound is 1e-3 px, or
    16 float32 ulps of the coordinate where that is larger (1.95e-3 px
    beyond 1024 px); TF32 products would miss by ~1e-3 relative, ~1 px."""
    arrays = dict(zip(GEOMETRY_INPUTS, (np.asarray(a) for a in (
        pair.frame1.rs_image, td, pair.frame1.rs_unproject,
        pair.frame2.poses_r, pair.frame2.poses_t))))
    gpu_px, gpu_valid, gpu_flow = geometry(arrays)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_geo_") as tmp:
        src = os.path.join(tmp, "in.npz")
        dst = os.path.join(tmp, "out.npz")
        np.savez(src, **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.geometry_file({src!r}, {dst!r})"],
            cwd=HERE, env=env, text=True, capture_output=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"CPU geometry child failed:\n"
                               f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        with np.load(dst) as f:
            cpu_px, cpu_valid, cpu_flow = f["px"], f["valid"], f["flow"]
    log(f"[geometry] CPU child: {time.perf_counter() - t0:.1f} s")

    def tol(coord):
        return np.maximum(1e-3, 16 * np.spacing(np.abs(coord).astype(
            np.float32)))

    h, w = td.shape
    grid = np.stack(np.meshgrid(np.arange(w, dtype=np.float32),
                                np.arange(h, dtype=np.float32)), -1)
    both = gpu_valid & cpu_valid
    d_rect = np.abs(gpu_px - cpu_px)[both]
    d_flow = np.abs(gpu_flow - cpu_flow)
    over = (int((d_rect > tol(cpu_px[both])).sum())
            + int((d_flow > tol(cpu_flow + grid)).sum()))
    log(f"[geometry] GPU vs CPU: rectify coordinates max {d_rect.max():.2e} "
        f"px over {int(both.sum())} pixels (valid masks differ at "
        f"{int((gpu_valid != cpu_valid).sum())}), true flow max "
        f"{d_flow.max():.2e} px; {over} values over the bound")
    if over or not (np.isfinite(d_rect).all() and np.isfinite(d_flow).all()):
        raise RuntimeError(f"GPU geometry differs from the CPU: rectify "
                           f"{d_rect.max()} px, true flow {d_flow.max()} px")


def multi_gpu(h=H, w=W, n=4):
    """DP over 4 pairs on a (4, 1) mesh and one pair sharded by scanline
    blocks on a (1, 4) mesh, each against single-card estimate_from_flow
    on the same precomputed (exact RS) flow and key."""
    from rs_sfm_tpu.config import PRODUCTION_CONFIG
    from rs_sfm_tpu.data.synthetic import (castle_scene, default_intrinsics,
                                           render_pair)
    from rs_sfm_tpu.flow.true_flow import true_flow
    from rs_sfm_tpu.parallel.api import (estimate_pairs_batched,
                                         estimate_sharded)
    from rs_sfm_tpu.parallel.mesh import make_mesh
    from rs_sfm_tpu.solver.pipeline import estimate_from_flow

    if len(jax.devices()) < n:
        raise RuntimeError(f"--multi-gpu needs {n} devices, JAX sees "
                           f"{len(jax.devices())}")
    cfg = PRODUCTION_CONFIG
    intr = default_intrinsics(h, w)
    scene = castle_scene(dtype=jnp.float32)
    flows = []
    for i in range(n):
        pair = render_pair(scene, intr, h, w, gamma=GAMMA, k=0.0,
                           v=V_TRUE * (1.0 - 0.1 * i), w=W_TRUE,
                           dtype=jnp.float32)
        flows.append(true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                               pair.frame2.poses_t, intr))
    flows = jnp.stack(flows)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    dp_mesh = make_mesh(pairs=n, pixels=1)
    sp_mesh = make_mesh(pairs=1, pixels=n)
    # The three programs compile concurrently (XLA compiles off the GIL).
    jobs = {
        "single": (jax.jit(lambda f, k: estimate_from_flow(
            f, intr, GAMMA, cfg, k)), (flows[0], keys[0])),
        "dp": (estimate_pairs_batched(dp_mesh, intr, GAMMA, cfg),
               (flows, keys)),
        "sharded": (jax.jit(estimate_sharded(sp_mesh, intr, GAMMA, cfg)),
                    (flows[0], keys[0])),
    }
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(lambda f, a: f.lower(*a).compile(),
                                     fn, args)
                   for name, (fn, args) in jobs.items()}
        compiled = {name: fut.result() for name, fut in futures.items()}
    log(f"[multi-gpu] compiled single, DP {dict(dp_mesh.shape)} and "
        f"scanline {dict(sp_mesh.shape)} programs in "
        f"{time.perf_counter() - t0:.1f} s")

    def agree(tag, v, num, f, k):
        ref = compiled["single"](f, k)
        a = np.asarray(v, np.float64)
        b = np.asarray(ref.v, np.float64)
        ang = float(np.arccos(np.clip(abs(a @ b) / (np.linalg.norm(a)
                                                    * np.linalg.norm(b)),
                                      -1, 1)))
        rel = abs(int(num) - int(ref.num_inliers)) / max(
            int(ref.num_inliers), 1)
        log(f"[multi-gpu] {tag}: v angle to single card {ang:.2e} rad, "
            f"inliers {int(num)} vs {int(ref.num_inliers)} ({rel:.2%})")
        if not (ang <= 1e-3 and rel <= 0.01):
            raise RuntimeError(f"{tag} disagrees with the single card")

    for name, args in (("dp", (flows, keys)),
                       ("sharded", (flows[0], keys[0]))):
        res = jax.block_until_ready(compiled[name](*args))
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled[name](*args))
            t.append(time.perf_counter() - t0)
        log(f"[multi-gpu] {name}: {np.median(t):.4f} s per call "
            f"({'4 pairs' if name == 'dp' else 'one pair'} {h}x{w})")
        if name == "dp":
            for i in range(n):
                agree(f"DP pair {i}", res.v[i], res.num_inliers[i],
                      flows[i], keys[i])
        else:
            agree("sharded pair 0", res.v, res.num_inliers, flows[0],
                  keys[0])
    t = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled["single"](flows[0], keys[0]))
        t.append(time.perf_counter() - t0)
    log(f"[multi-gpu] single card: {np.median(t):.4f} s per pair")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi-gpu", action="store_true",
                        help="run only the four-card phase")
    args = parser.parse_args(argv)

    dev = phase_device()
    if args.multi_gpu:
        multi_gpu()
    else:
        phase_cli()
        intr, pair, gt, td = render_castle()
        flow = phase_fullhd(dev, intr, pair, gt, td)
        phase_sor(pair, flow)
        phase_geometry(pair, td)
    from rs_sfm_tpu.utils.runtime import nvidia_smi_name_power

    print(nvidia_smi_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
