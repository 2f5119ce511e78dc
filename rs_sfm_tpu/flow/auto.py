"""Automatic flow-preset selection ("--flow-model auto").

The reference runs ONE configuration everywhere (src/main.cc:304-311);
this repo's measured reality is that the LCN-robust preset costs ~3x
accuracy on clean scenes (STRESS.md ablation: clean err_v 0.123 robust vs
0.040 plain) while plain collapses under photometric nuisance or heavy
occlusion.  `probe_flow_preset` restores the single-configuration UX with
a cheap coarse-scale probe run once per pair:

  * compute a small plain forward-backward flow at 1/8 resolution
    (135x240 at full-HD);
  * occlusion fraction of the FB test: photometric corruption makes the
    plain flow inconsistent (measured castle_photo 0.84) and movers +
    heavy occlusion flag directly (stress 0.62), while clean scenes stay
    low (castle_clean 0.14) — threshold 0.35 sits >2x from both sides;
  * aligned log-gain field of the warped pair: exposure/vignetting shows
    as a biased or spread log(blur(I1)/blur(I2w)) (photo: spread 0.095 vs
    clean/stress 0.010) — a second, independent trigger for photometric
    problems even when the flow still round-trips.

Measured signals: results/err3d_decompose.json companion run and the
header measurement in this module's r4 commit; gates in
tests/test_fullhd_flow.py::test_auto_preset_selection.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from rs_sfm_tpu.flow.dense import (DenseFlowConfig, _downsample, _gauss_blur,
                                   _to_gray, _warp, flow_forward_backward)

# Probe thresholds (see module docstring for the measured per-scene
# values these separate).  r5: the occlusion trigger is OFF by default
# (None) — movers/large-motion inflate the probe's occ fraction (stress:
# 0.62) but LCN is the wrong medicine for them (occlusion MASKS are; the
# robust preset measured 8.95 px median vs 2.11 variational on the mover
# scene, results/flow_matrix_r5.json), while actual photometric
# corruption is already caught by the aligned gain field (photo spread
# 0.095 vs clean/stress 0.010 — >2x margins on both sides).
OCC_THRESHOLD = None
GAIN_SPREAD_THRESHOLD = 0.04
GAIN_BIAS_THRESHOLD = 0.015


@functools.partial(jax.jit, static_argnames=("cfg",))
def _probe_stats(i1, i2, cfg: DenseFlowConfig):
    fb = flow_forward_backward(i1, i2, cfg)
    occ_frac = jnp.mean(fb.occlusion.astype(jnp.float32))
    i2w = _warp(i2, fb.flow)
    b1 = _gauss_blur(_gauss_blur(i1))
    b2 = _gauss_blur(_gauss_blur(i2w))
    lg = jnp.log((b1 + 1e-2) / (b2 + 1e-2))
    m = ~fb.occlusion
    # Masked quantiles via sorting with occluded entries pushed to +inf /
    # counted out (fixed-shape).
    n_ok = jnp.maximum(jnp.sum(m), 1)
    flat = jnp.where(m, lg, jnp.inf).reshape(-1)
    srt = jnp.sort(flat)
    q = lambda p: srt[jnp.minimum(  # noqa: E731
        (p * n_ok.astype(jnp.float32)).astype(jnp.int32),
        flat.shape[0] - 1)]
    bias = jnp.abs(q(0.5))
    spread = q(0.9) - q(0.1)
    return occ_frac, bias, spread


def probe_flow_preset(image1, image2, *, downsamples: int = 3,
                      occ_threshold: float = OCC_THRESHOLD,
                      gain_spread_threshold: float = GAIN_SPREAD_THRESHOLD,
                      gain_bias_threshold: float = GAIN_BIAS_THRESHOLD,
                      return_stats: bool = False):
    """Choose "variational" (plain) or "robust" (LCN) for this pair.

    Args:
      image1, image2: (H, W[, 3]) float frames in [0, 1].
      downsamples: pyramid downsamples before the probe (3 = 1/8 scale).

    Returns:
      preset name, or (name, stats dict) with return_stats.
    """
    i1 = _to_gray(jnp.asarray(image1, jnp.float32))
    i2 = _to_gray(jnp.asarray(image2, jnp.float32))
    for _ in range(downsamples):
        if min(i1.shape) < 64:
            break  # keep the probe statistically meaningful on small pairs
        i1 = _downsample(i1)
        i2 = _downsample(i2)
    cfg = DenseFlowConfig(levels=4, iters=12, warps=2)
    occ_frac, bias, spread = (float(x) for x in _probe_stats(i1, i2, cfg))
    robust = (spread > gain_spread_threshold
              or bias > gain_bias_threshold
              or (occ_threshold is not None and occ_frac > occ_threshold))
    name = "robust" if robust else "variational"
    if return_stats:
        return name, {"occ_frac": occ_frac, "gain_bias": bias,
                      "gain_spread": spread}
    return name
