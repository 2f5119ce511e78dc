"""Profiling: wall-clock stage timers, jax.profiler traces, and the
reduction of a device trace to per-stage device time.

The reference's only instrumentation is Ceres' BriefReport printouts
(src/nonlinearRefinement.cc:165-169).  Here: a Timer, a timing helper that
ends every call with block_until_ready, per-stage timing of the pipeline,
and `device_stage_times`, which attributes every kernel of a traced step to
the pipeline stage (jax.named_scope) it came from.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import re
import time
from typing import Callable, Dict, Iterable

import numpy as np

import jax

# Named scopes of the production path (flow/dense.py, solver/pipeline.py,
# rectify/backproject.py).  A kernel belongs to the innermost of them on
# its op_name path, except that everything under "feedback" (mask
# extension and re-estimation) counts as feedback.
STAGES = ("flow_pyramid", "flow_match", "flow_warp", "flow_linearise",
          "flow_sor", "flow_median", "fb_occlusion", "ransac", "refine_lm",
          "feedback", "rectify")


class Timer:
    """Accumulating wall-clock timer keyed by stage name."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(sorted(self.times.items(), key=lambda kv: -kv[1]))


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median wall time of fn(*args), each call ended by block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_COMPUTATION = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")
_INSTRUCTION = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_op_names(hlo_texts: Iterable[str]) -> Dict[str, str]:
    """HLO instruction name -> its op_name metadata (the jax.named_scope
    path), from compiled-module text (`compiled.as_text()`).  A fusion
    without metadata of its own takes the first op_name inside the
    computation it calls."""
    names, calls, first = {}, {}, {}
    for text in hlo_texts:
        comp = None
        for line in text.splitlines():
            m = _COMPUTATION.match(line)
            if m:
                comp = m.group(1)
                continue
            m = _INSTRUCTION.match(line)
            if not m:
                continue
            op = _OP_NAME.search(line)
            if op:
                names[m.group(1)] = op.group(1)
                if comp is not None:
                    first.setdefault(comp, op.group(1))
            else:
                c = _CALLS.search(line)
                if c:
                    calls[m.group(1)] = c.group(1)
    for name, comp in calls.items():
        if comp in first:
            names.setdefault(name, first[comp])
    return names


def stage_of(op_name: str) -> str:
    parts = op_name.split("/")
    if "feedback" in parts:
        return "feedback"
    for p in reversed(parts):
        if p in STAGES:
            return p
    return "other"


def _busy_ns(intervals) -> float:
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def device_stage_times(log_dir: str, hlo_texts: Iterable[str], *,
                       plane_prefix: str = "/device:GPU",
                       top: int = 25) -> dict:
    """Reduce the newest trace under `log_dir` to device time per stage.

    Events are the device's kernels (events that carry an `hlo_op` stat,
    on planes named `plane_prefix*`); each is attributed through its HLO
    instruction's op_name (hlo_op_names of `hlo_texts`) to a STAGES entry
    or "other".  Busy time is the union of the kernel intervals; the window
    runs from the first kernel's start to the last one's end, and the idle
    share is 1 - busy / window.  top_ops: the `top` op_name paths with the
    most device time, and their kernel counts.
    """
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    names = hlo_op_names(hlo_texts)
    stage_ns = collections.defaultdict(float)
    op_ns = collections.defaultdict(float)
    op_count = collections.Counter()
    unmapped = collections.Counter()
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                op_name = names.get(str(op))
                if op_name is None:
                    unmapped[str(op)] += 1
                    op_name = ""
                stage_ns[stage_of(op_name)] += ev.duration_ns
                op_ns[op_name or str(op)] += ev.duration_ns
                op_count[op_name or str(op)] += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise ValueError(f"no kernel events on {plane_prefix}* planes")
    busy = _busy_ns(intervals)
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    return {
        "stage_ms": {k: v / 1e6 for k, v in sorted(
            stage_ns.items(), key=lambda kv: -kv[1])},
        "busy_ms": busy / 1e6, "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "kernels": len(intervals), "unmapped_ops": sum(unmapped.values()),
        "top_ops": {k: {"ms": v / 1e6, "kernels": op_count[k]}
                    for k, v in sorted(op_ns.items(),
                                       key=lambda kv: -kv[1])[:top]},
    }


def stage_timings(flow_px, intr, gamma, cfg, key, iters: int = 3):
    """Per-stage wall times of the estimation pipeline (jitted per stage).

    Returns {stage: seconds} for: prepare, ransac_solve+score, refine.
    """
    from rs_sfm_tpu.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu.solver.ransac import ransac
    from rs_sfm_tpu.solver.refine import refine

    use_k = cfg.use_acceleration and not cfg.use_global_shutter

    prep = jax.jit(lambda f: prepare_flow_inputs(f, intr, gamma, cfg))
    coords, flow_n, alpha, alpha_k, valid = prep(flow_px)

    def run_ransac(c, f, a, ak, vm, k):
        return ransac(c, f, a, ak, vm, key=k, use_k=use_k,
                      trials=cfg.ransac_trials, tolerance=cfg.ransac_tol,
                      chunk=cfg.ransac_chunk)

    ransac_j = jax.jit(run_ransac)
    rr = ransac_j(coords, flow_n, alpha, alpha_k, valid, key)

    refine_j = jax.jit(lambda *a: refine(
        *a, optimize_k=use_k, iterations=cfg.refine_iterations))

    out = {
        "prepare": time_fn(prep, flow_px, iters=iters),
        "ransac": time_fn(ransac_j, coords, flow_n, alpha, alpha_k, valid,
                          key, iters=iters),
        "refine": time_fn(
            refine_j, coords, flow_n, alpha, alpha_k, rr.inlier_mask,
            rr.v, rr.w, rr.k, rr.inv_depth, iters=iters),
    }
    return out
