"""Dense optical flow: pyramidal coarse-to-fine variational estimation.

Replaces the reference's OpenCV DeepFlow call (src/camera.cc:253-277) with a
JAX implementation of the same family of algorithm (DeepFlow =
variational energy in a coarse-to-fine pyramid + a matching term; here the
variational core, structure-texture preprocessing, and warping pyramid):

  * Gaussian pyramid over both frames;
  * at each level, several warping iterations: bilinearly warp I2 by the
    current flow, linearize the brightness-constancy term, and minimize
      E = Σ ψ(Ix·du + Iy·dv + It) + λ‖∇(u+du)‖²
    with fixed-point (lagged-diffusivity) red-black SOR sweeps — pure
    stencil and elementwise ops (fused on a GPU by ops/sor_cuda.py);
  * 3x3 median filtering of the flow between warps (the standard outlier
    cleanup), via a sorting network on rolled neighbors;
  * everything fixed-shape and jittable; the pyramid loop unrolls at trace
    time (static level count).

Quality target: ≥ DeepFlow on the synthetic castle pairs (SURVEY.md §2.3);
real-image robustness improves with the census/gradient-constancy terms
(gradient constancy included below).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class DenseFlowConfig(NamedTuple):
    levels: int = 6            # pyramid levels (auto-capped by image size)
    warps: int = 3             # warping iterations per level
    iters: int = 20            # red-black SOR sweeps per warp
    # Separate settings for the NON-finest levels (0 = same as
    # warps/iters).  Coarse levels only initialize the continuation —
    # their solution is upsampled and re-solved.
    warps_coarse: int = 0
    iters_coarse: int = 0
    omega: float = 1.85        # SOR over-relaxation factor
    smoothness: float = 0.08   # λ: smoothness weight
    gamma_grad: float = 0.7    # gradient-constancy weight
    eps: float = 1e-3          # Charbonnier epsilon
    median: bool = True        # 3x3 median filter between warps
    # Structure-texture decomposition: run the data term on the texture
    # component I − α·blur(I), suppressing illumination changes and shadows
    # (the standard TV-L1/DeepFlow-class preprocessing for real images).
    struct_texture: float = 0.0  # 0 = off; typical 0.8-0.95 for real pairs
    # Local contrast normalization: replace I by
    #   (I − μ) / √(σ² + lcn²),  μ/σ² = local (double-5-tap) mean/variance.
    # Invariant to any smooth gain AND offset field (exposure, vignetting)
    # — the census property — while keeping the data term a plain
    # brightness constancy, so the fused SOR kernel and the
    # discrete-matching stages work unchanged.  This is the production
    # robust preprocessing; `lcn` is the contrast floor (≈ noise level).
    lcn: float = 0.0  # 0 = off; typical 0.03-0.08 for real imagery
    # Multiplicative gain correction (exposure / vignetting), measured as
    # the strongest robust mode on the full-HD photometric stress scene
    # (results/flow_variants.json): per warp, the smooth gain-ratio field
    # of the ALIGNED pair (blur(I1)/blur(I2w) at the level's grid scale,
    # clipped to [0.7, 1.4]) is multiplied into I2w before linearization —
    # residual illumination vanishes as the flow converges (measured on
    # GT-aligned full-HD photo pair: |residual| 0.075 → 0.0018).  The
    # ratio MUST be computed aligned — an up-front unaligned ratio at any
    # blur scale carries ~0.2 std of parallax-induced structure and
    # corrupts the data term.  The discrete matching stages switch to
    # contrast-normalized patches (gain-invariant) under this flag.  On
    # photometrically clean pairs the aligned ratio is ≈1, so the mode is
    # a no-op — unlike census/LCN it costs no accuracy on clean scenes,
    # and it adds no data-term channels (fused SOR kernel compatible).
    gain_correct: bool = False
    # Discrete matching (DeepFlow's matching-term role):
    #  - exhaustive ±init_search_radius search at the coarsest level;
    #  - warp-local ±refine_search_radius search at every non-finest level
    #    (corrects coarse mismatches where texture is richer, DIS-style).
    # Captures displacements up to ~radius·2^levels px at full resolution.
    init_search_radius: int = 8   # 0 = pure variational
    refine_search_radius: int = 4  # 0 = off
    # Apply the warp-local search at full radius only at levels whose min
    # dimension is at most this ((2r+1)² warps at near-full resolution are
    # the cost driver; large displacements are locked in by the coarse
    # levels).
    refine_max_size: int = 192
    # Above refine_max_size (every non-finest level), run the warp-local
    # search at this smaller radius instead (0 = off) — the DIS-style
    # inverse-search role for fine levels.  Measured at full-HD
    # (results/flow_variants.json) it buys no accuracy (the variational
    # term tracks fine-level corrections) and adds a (2r+1)² warp scan at
    # near-full resolution, so it defaults off; it remains available for
    # scenes with very fast fine-scale motion.
    refine_fine_radius: int = 0
    # Ambiguity (ratio) test for the discrete matching stages (0 = off).
    # On REPETITIVE texture every period-shifted displacement is an
    # equally good SSD match, and the discrete search mislocks once the
    # period enters its radius (measured: 38.8 px median EPE on the
    # strictly-periodic reptex probe, results/flow_variants_r4.json) — a
    # failure no descriptor strength can fix, since the ambiguity is in
    # the image itself.  With the test on, a discrete match is accepted
    # only when its cost beats every alternative ≥2 px away by this
    # factor (best < ratio·second); ambiguous pixels keep the variational
    # continuation flow, whose coarse-to-fine lock stays within half a
    # period per level.  Typical 0.8-0.9.
    match_ratio: float = 0.0
    # Ternary-census data term (0 = off): 8 soft-sign neighbor-comparison
    # channels, each with its own Charbonnier penalty — invariant to any
    # monotone local illumination change (stronger than structure-texture,
    # which only removes low-frequency gain).  Typical 0.5-1.5 for real
    # imagery with exposure/vignetting changes.
    census_weight: float = 0.0
    census_sigma: float = 0.04  # soft-sign scale: tanh-like d/√(d²+σ²)
    # SOR sweep engine: "auto" runs the fused multi-sweep CUDA kernel
    # (ops/sor_cuda.py) on a GPU at the levels it supports and the XLA
    # loop elsewhere; "xla" always runs the XLA loop (the reference).
    sor_engine: str = "auto"
    # Brightness-constancy weight.  Set to 0 (with gamma_grad=0) to run a
    # census-only data term — the robust configuration for real imagery
    # with exposure/vignetting/gamma changes, where raw brightness (and
    # gradient magnitude) constancy actively mislead the solver.
    brightness_weight: float = 1.0
    # Forward-backward occlusion test (flow_forward_backward): pixel x is
    # flagged when |w_f(x) + w_b(x+w_f)|² > occ_rel·(|w_f|²+|w_b|²) +
    # occ_abs (Sundaram-Brox thresholds).
    occ_rel: float = 0.01
    occ_abs: float = 0.5
    # Photoconsistency occlusion cue: additionally flag pixels where
    # |LCN(I1) − warp(LCN(I2))| exceeds this (in local-contrast units,
    # ~N(0,1) scaled; 0 = off).  Catches occlusion SMEAR bands the FB test
    # misses: background covered by a moving foreground edge inherits the
    # foreground's flow, and the backward flow of the foreground surface
    # round-trips consistently — both checks agree on the wrong answer,
    # but the warped texture does not match (measured: the failure stripes
    # at the castle tower edges, results/flow_variants.json).
    occ_photo: float = 0.0
    # Resolution divisor for the BACKWARD flow in flow_forward_backward
    # (1 = full resolution; must be a POWER OF TWO — it is realized as
    # log2(scale) pyramid downsamples).  The backward field is only
    # consumed by the forward-backward occlusion test — a
    # morphological-scale signal — so computing it on 2x-downsampled
    # frames (1/4 the pixels) leaves the mask quality essentially
    # unchanged (measured: results/stress_fullhd.json occ stats).
    backward_scale: int = 1
    # Warp-local search realization (r5):
    #   True — "shifted" mode: warp I2 by the incoming flow ONCE, then
    #     build the full (2r+1)^2 cost volume from INTEGER SHIFTS of the
    #     warped plane — one batched computation, no per-candidate warp
    #     or scan step.  Approximation: candidate d's cost is evaluated
    #     through flow(x+d) instead of flow(x) (DIS-style propagation
    #     semantics); where flow is smooth — everywhere after the coarse
    #     lock — the two coincide.  Where the incoming flow is ROUGH
    #     (e.g. brightness constancy wrecked by nonlinear illumination,
    #     the census preset's regime) the approximation evaluates
    #     near-random candidates — measured 2.3 -> 7.5 px median EPE on
    #     the vignette+gamma probe — so the default stays exact and the
    #     smooth-flow production presets opt in (models/__init__.py).
    #   False — r4 exact mode (default): re-warp I2 at every candidate.
    refine_shifted: bool = False
    # Anchored pass (flow/relock.py pass 1): ZERO the variational data
    # term at discrete-ambiguous pixels, so their flow is pure smoothness
    # interpolation from the unambiguous anchors instead of a wrong-lock
    # measurement.  On periodic texture the wrong lock otherwise DRAGS
    # the neighboring unambiguous pixels through the smoothness coupling
    # (measured on reptex: anchor purity 19% with the ambiguity mask
    # alone — the contamination, not the mask, is the blocker).
    anchor_ambiguous: bool = False


def _to_gray(img):
    if img.ndim == 3:
        return (0.299 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2])
    return img


def _shift(x, s: int, axis: int):
    """Edge-clamped shift: out[i] = x[clip(i - s, 0, n-1)] along `axis`.

    Same sign convention as jnp.roll, but replicating the edge instead of
    wrapping around.  Wrap-around is actively wrong for RS flow fields: the
    per-scanline pose makes the top and bottom rows of the flow field
    maximally different, so a torus smoothness/stencil boundary drags both
    ends toward each other (and blur/gradient wraps bleed opposite borders
    into the data term).
    """
    if s == 0:
        return x
    n = x.shape[axis]
    if s > 0:
        body = jax.lax.slice_in_dim(x, 0, n - s, axis=axis)
        edge = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
        parts = [edge] * s + [body]
    else:
        body = jax.lax.slice_in_dim(x, -s, n, axis=axis)
        edge = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
        parts = [body] + [edge] * (-s)
    return jnp.concatenate(parts, axis=axis)


def _shift2(x, dy: int, dx: int):
    """Edge-clamped 2-D shift (rows axis 0, cols axis 1)."""
    return _shift(_shift(x, dy, 0), dx, 1)


def _gauss_blur(x):
    """5-tap binomial blur, separable, edge-replicated boundaries."""
    k = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], x.dtype) / 16.0

    def conv1d(v, axis):
        out = jnp.zeros_like(v)
        for i, w in enumerate(k):
            out = out + w * _shift(v, i - 2, axis)
        return out

    return conv1d(conv1d(x, 0), 1)


def _downsample(x):
    return _gauss_blur(x)[::2, ::2]


def _up2(x):
    """Exact 2x bilinear upsample of a (H, W) plane.

    An interleave formulation (even samples copy, odd samples average
    with the edge-clamped next neighbor): a handful of fused elementwise
    ops instead of jax.image.resize's general resampling.
    """
    h, w = x.shape
    # Half-pixel-center convention (matches jax.image.resize bilinear):
    # fine sample j sits at coarse coordinate j/2 - 0.25, so
    # out[2i] = 0.75 x[i] + 0.25 x[i-1], out[2i+1] = 0.75 x[i] + 0.25
    # x[i+1] (edge-clamped).  Sample-aligned interleaving instead would
    # shift the field by half a fine pixel per level transition —
    # measured as a census-flow regression.
    rows = jnp.stack([0.75 * x + 0.25 * _shift(x, 1, 0),
                      0.75 * x + 0.25 * _shift(x, -1, 0)], axis=1)
    rows = rows.reshape(2 * h, w)
    cols = jnp.stack([0.75 * rows + 0.25 * _shift(rows, 1, 1),
                      0.75 * rows + 0.25 * _shift(rows, -1, 1)], axis=2)
    return cols.reshape(2 * h, 2 * w)


def _upsample_flow(flow, shape):
    """Resize flow to `shape` and scale the vectors accordingly.

    Pyramid levels differ by exactly 2x up to a +1 remainder on odd dims;
    that case takes the cheap interleave path (edge-replicating the last
    row/column).  Arbitrary ratios fall back to jax.image.resize.
    """
    h, w = shape
    fh, fw = flow.shape[:2]
    if 0 <= h - 2 * fh <= 1 and 0 <= w - 2 * fw <= 1:
        u = _up2(flow[..., 0])
        v = _up2(flow[..., 1])
        out = jnp.stack([u, v], axis=-1)
        if h - 2 * fh or w - 2 * fw:
            out = jnp.pad(out, ((0, h - 2 * fh), (0, w - 2 * fw), (0, 0)),
                          mode="edge")
    else:
        out = jax.image.resize(flow, (h, w, 2), method="bilinear")
    scale = jnp.asarray([w / fw, h / fh], flow.dtype)
    return out * scale


def _warp(img, flow):
    """Bilinear sample img at (x + flow); out-of-bounds clamps to edge."""
    h, w = img.shape[:2]
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=flow.dtype),
                          jnp.arange(w, dtype=flow.dtype), indexing="ij")
    x = jnp.clip(xs + flow[..., 0], 0.0, w - 1.0)
    y = jnp.clip(ys + flow[..., 1], 0.0, h - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = x - x0.astype(flow.dtype)
    fy = y - y0.astype(flow.dtype)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]

    def gather(yy, xx):
        return img[yy, xx]

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _gradients(img):
    """Central-difference spatial gradients, edge-clamped boundaries
    (one-sided half-differences at the borders)."""
    ax_x = img.ndim - 1
    ax_y = img.ndim - 2
    gx = (_shift(img, -1, ax_x) - _shift(img, 1, ax_x)) * 0.5
    gy = (_shift(img, -1, ax_y) - _shift(img, 1, ax_y)) * 0.5
    return gx, gy


_CENSUS_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                   (0, 1), (1, -1), (1, 0), (1, 1))


def _census_channels(img, sigma):
    """Soft ternary census: 8 neighbor-difference channels, soft-signed.

    d_n(x) = I(x+n) − I(x) mapped through d/√(d²+σ²) ∈ (−1, 1) — the
    differentiable relaxation of the census transform's sign comparisons.
    Constancy of these channels is invariant to monotone local illumination
    changes (the census property), unlike brightness or gradient constancy.
    """
    ch = [_shift2(img, dy, dx) - img for dy, dx in _CENSUS_OFFSETS]
    c = jnp.stack(ch)  # (8, H, W)
    return c / jnp.sqrt(c * c + sigma * sigma)


def _local_contrast_norm(x, eps: float):
    """(x − μ)/√(σ² + eps²) with local (double-5-tap) mean μ and variance
    σ² — invariant to smooth gain and offset fields (exposure, vignette)."""
    mu = _gauss_blur(_gauss_blur(x))
    d = x - mu
    var = _gauss_blur(_gauss_blur(d * d))
    return d * jax.lax.rsqrt(var + eps * eps)


def _median3(x):
    """3x3 median via a 9-element sorting network on edge-clamped shifts."""
    vals = [_shift2(x, dy, dx)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

    def cas(a, b):
        return jnp.minimum(a, b), jnp.maximum(a, b)

    # Optimal 9-element median network (19 comparators).
    v = list(vals)
    pairs = [(0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4),
             (6, 7), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
             (4, 2), (6, 4), (4, 2)]
    for a, b in pairs:
        v[a], v[b] = cas(v[a], v[b])
    return v[4]


def _median_flow(flow):
    """3x3 median of both flow planes."""
    return jnp.stack([_median3(flow[..., 0]), _median3(flow[..., 1])],
                     axis=-1)


def _box5(x):
    for axis in (x.ndim - 2, x.ndim - 1):
        x = (_shift(x, -2, axis) + _shift(x, -1, axis) + x
             + _shift(x, 1, axis) + _shift(x, 2, axis))
    return x


def _match_planes(i1, i2, cfg):
    """Preprocessing for the discrete matching stages: locally
    mean-removed (offset robust at the level's scale, and immune to
    struct-texture high-pass leaving no coarse content); under
    gain_correct contrast-normalized too (NCC-like — multiplicative gain
    cancels from the match cost)."""
    if cfg is not None and cfg.gain_correct:
        return _local_contrast_norm(i1, 0.05), _local_contrast_norm(i2, 0.05)
    return i1 - _gauss_blur(i1), i2 - _gauss_blur(i2)


# Ambiguity threshold for the EXPORTED mask (independent of the
# match_ratio selection knob): a best match that fails to beat its
# closest >=2 px alternative by 10% carries no lock information — on
# strictly periodic texture every period shift ties (cost ratio -> 1).
_AMB_RATIO = 0.9
# Prior tie-break strength (see `prior` in dense_flow_aux): multiplies
# the match cost by up to (1 + _PRIOR_W) at candidates far from the
# prior.  Small enough that a photometrically confident match (ratio
# test < 0.9) always survives; large enough to decide exact ties.
_PRIOR_W = 0.35


def _prior_factor(d2, radius, dtype):
    s2 = jnp.asarray(float(max(radius, 1)) ** 2, dtype)
    return 1.0 + _PRIOR_W * d2 / (d2 + s2)


def _match_scan(i1, cost_of, cand_of, side, *, prior=None, radius=1,
                ratio=0.0, fallback=None):
    """Shared (2r+1)^2 scan: track (best, second>=2px-away, ambiguity).

    cost_of(dy, dx) -> (H, W) raw match cost of integer offset (dy, dx)
    (0-based grid); cand_of(dy, dx) -> (H, W, 2) the candidate flow.
    prior: optional (H, W, 2) flow whose distance tie-breaks via a
    multiplicative penalty on the SELECTION cost (raw costs keep feeding
    the second/ambiguity bookkeeping).  ratio/fallback: match_ratio
    rejection (ignored when prior is given — the prior already
    disambiguates, and dropping to the fallback is what re-locks wrong).
    Returns (best_flow (H,W,2), second_flow (H,W,2), ambiguous (H,W)).
    The second flow is the best >=2 px-away ALTERNATIVE lock — on
    periodic texture (best − second) is ±one image-space period vector,
    the input to the global disambiguation (flow/relock.py).
    """
    dys = jnp.repeat(jnp.arange(side), side)
    dxs = jnp.tile(jnp.arange(side), side)

    def body(carry, off):
        best_sel, best_cost, second_cost, best, second = carry
        dy, dx = off
        cost = cost_of(dy, dx)
        cand = cand_of(dy, dx)
        if prior is not None:
            diff = cand - prior
            d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2
            sel = cost * _prior_factor(d2, radius, cost.dtype)
        else:
            sel = cost
        better = sel < best_sel
        # Ambiguity bookkeeping: best alternative >=2 px from the current
        # best; a dethroned best becomes the second when far enough from
        # the new winner.  Raw costs — the prior must not mask ambiguity.
        far = (jnp.abs(cand - best).max(axis=-1) > 1.5)
        to_second = better & far                  # dethroned best
        new_second = ~better & far & (cost < second_cost)
        second_cost = jnp.where(
            better, jnp.where(far, best_cost, second_cost),
            jnp.where(new_second, cost, second_cost))
        second = jnp.where(to_second[..., None], best,
                           jnp.where(new_second[..., None], cand, second))
        best_cost = jnp.where(better, cost, best_cost)
        best_sel = jnp.where(better, sel, best_sel)
        best = jnp.where(better[..., None], cand, best)
        return (best_sel, best_cost, second_cost, best, second), None

    shape = i1.shape
    inf = jnp.full(shape, jnp.inf, i1.dtype)
    init = (inf, inf, inf, jnp.zeros(shape + (2,), i1.dtype),
            jnp.zeros(shape + (2,), i1.dtype))
    (_, best_cost, second_cost, best, second), _ = jax.lax.scan(
        body, init, (dys, dxs))
    amb = best_cost >= _AMB_RATIO * second_cost
    if ratio > 0.0 and prior is None and fallback is not None:
        ok = best_cost < ratio * second_cost
        best = jnp.where(ok[..., None], best, fallback)
    return best, second, amb


def _coarse_init(i1, i2, radius: int, cfg=None, prior=None):
    """Exhaustive integer-displacement search at the coarsest level.

    For every pixel, pick the displacement in [−radius, radius]² minimizing
    the 5x5 box-filtered squared difference — the stand-in for
    DeepFlow's matching term (dense HOG matches).  Scanned over offsets
    (an unrolled loop of static rolls makes XLA compile times explode);
    the shifted window comes from a dynamic slice of the edge-padded
    image.  Returns (flow, ambiguous).
    """
    i1, i2 = _match_planes(i1, i2, cfg)
    padded = jnp.pad(i2, radius, mode="edge")
    side = 2 * radius + 1

    def cost_of(dy, dx):
        shifted = jax.lax.dynamic_slice(padded, (dy, dx), i1.shape)
        return _box5((shifted - i1) ** 2)

    def cand_of(dy, dx):
        du = (dx - radius).astype(i1.dtype)
        dv = (dy - radius).astype(i1.dtype)
        return jnp.stack([jnp.full(i1.shape, du, i1.dtype),
                          jnp.full(i1.shape, dv, i1.dtype)], axis=-1)

    ratio = cfg.match_ratio if cfg is not None else 0.0
    best, second, amb = _match_scan(
        i1, cost_of, cand_of, side, prior=prior, radius=radius,
        ratio=ratio, fallback=jnp.zeros(i1.shape + (2,), i1.dtype))
    # Median-clean the discrete field (kills isolated mismatches).
    return (jnp.stack([_median3(best[..., 0]), _median3(best[..., 1])],
                      axis=-1), second, amb)


def _discrete_refine(i1, i2, flow, radius: int, cfg, prior=None):
    """Warp-local integer search: test flow + d for d ∈ [−radius, radius]²
    and keep the best box-filtered SSD per pixel.

    Two realizations (cfg.refine_shifted):
      * shifted: warp I2 by `flow` ONCE, then each candidate's cost
        comes from an integer SHIFT of the warped plane — cost(x, d)
        tests displacement flow(x+d)+d instead of flow(x)+d
        (DIS-inverse-search semantics; equal wherever flow is locally
        smooth), with no per-candidate warp.
      * exact (default): per-candidate re-warp.
    Returns (flow, ambiguous).
    """
    i1m, i2m = _match_planes(i1, i2, cfg)
    side = 2 * radius + 1

    if cfg.refine_shifted:
        w0 = _warp(i2m, flow)
        padded = jnp.pad(w0, radius, mode="edge")

        def cost_of(dy, dx):
            shifted = jax.lax.dynamic_slice(padded, (dy, dx), i1m.shape)
            return _box5((shifted - i1m) ** 2)
    else:
        def cost_of(dy, dx):
            du = (dx - radius).astype(i1m.dtype)
            dv = (dy - radius).astype(i1m.dtype)
            cand = flow + jnp.stack(
                [jnp.full(i1m.shape, du, i1m.dtype),
                 jnp.full(i1m.shape, dv, i1m.dtype)], axis=-1)
            return _box5((_warp(i2m, cand) - i1m) ** 2)

    def cand_of(dy, dx):
        du = (dx - radius).astype(i1m.dtype)
        dv = (dy - radius).astype(i1m.dtype)
        return flow + jnp.stack([jnp.full(i1m.shape, du, i1m.dtype),
                                 jnp.full(i1m.shape, dv, i1m.dtype)],
                                axis=-1)

    best, second, amb = _match_scan(i1m, cost_of, cand_of, side,
                                    prior=prior, radius=radius,
                                    ratio=cfg.match_ratio, fallback=flow)
    return _median_flow(best), second, amb


class Linearised(NamedTuple):
    """Planes of the linearised data term at one warp (all (H, W)).

    (u0, v0) is the flow the warp started from; c, cgx, cgy are the
    constant parts of the brightness and gradient residuals written in
    absolute flow: r = c + ix·u + iy·v."""
    ix: jax.Array
    iy: jax.Array
    it: jax.Array
    ixx: jax.Array
    ixy: jax.Array
    iyy: jax.Array
    gtx: jax.Array
    gty: jax.Array
    u0: jax.Array
    v0: jax.Array
    c: jax.Array
    cgx: jax.Array
    cgy: jax.Array


def _navg(z):
    """4-neighbour mean.  Neumann boundary: the missing neighbor beyond an
    image edge is the edge pixel itself (edge-clamped shifts)."""
    return (_shift(z, 1, 0) + _shift(z, -1, 0)
            + _shift(z, 1, 1) + _shift(z, -1, 1)) * 0.25


def _point_solve(t: Linearised, u, v, ubar, vbar, cfg: DenseFlowConfig,
                 census=None):
    """Pointwise 2x2 solve of the linearised data term given the current
    neighbor averages, with lagged-diffusivity (Charbonnier') weights.
    census: optional (du, dv) -> (a11, a12, a22, b1, b2) increments."""
    lam = cfg.smoothness
    eps2 = cfg.eps * cfg.eps
    du = u - t.u0
    dv = v - t.v0
    r = t.ix * du + t.iy * dv + t.it
    wd = cfg.brightness_weight / jnp.sqrt(r * r + eps2)
    rgx = t.gtx + t.ixx * du + t.ixy * dv
    rgy = t.gty + t.ixy * du + t.iyy * dv
    wg = cfg.gamma_grad / jnp.sqrt(rgx * rgx + rgy * rgy + eps2)
    a11 = lam + wd * t.ix * t.ix + wg * (t.ixx * t.ixx + t.ixy * t.ixy)
    a12 = wd * t.ix * t.iy + wg * (t.ixx * t.ixy + t.ixy * t.iyy)
    a22 = lam + wd * t.iy * t.iy + wg * (t.ixy * t.ixy + t.iyy * t.iyy)
    b1 = (lam * ubar - wd * t.ix * t.c
          - wg * (t.ixx * t.cgx + t.ixy * t.cgy))
    b2 = (lam * vbar - wd * t.iy * t.c
          - wg * (t.ixy * t.cgx + t.iyy * t.cgy))
    if census is not None:
        c11, c12, c22, cb1, cb2 = census(du, dv)
        a11 = a11 + c11
        a12 = a12 + c12
        a22 = a22 + c22
        b1 = b1 - cb1
        b2 = b2 - cb2
    det = a11 * a22 - a12 * a12
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    u_new = (a22 * b1 - a12 * b2) / det
    v_new = (a11 * b2 - a12 * b1) / det
    return u_new, v_new


def sor_sweeps_xla(t: Linearised, iters: int, cfg: DenseFlowConfig,
                   census=None):
    """`iters` red-black Gauss-Seidel sweeps with over-relaxation, starting
    from (u0, v0): each color updates against the other's fresh values —
    ~4x fewer sweeps than Jacobi for the same residual.  The reference
    for the fused kernel in ops/sor_cuda.py."""
    ys = jnp.arange(t.u0.shape[0])[:, None]
    xs = jnp.arange(t.u0.shape[1])[None, :]
    checker = ((ys + xs) % 2).astype(t.u0.dtype)

    def sweep(_, uv):
        u, v = uv
        for color in (0.0, 1.0):
            u_s, v_s = _point_solve(t, u, v, _navg(u), _navg(v), cfg,
                                    census)
            mask = jnp.where(checker == color, cfg.omega, 0.0)
            u = u + mask * (u_s - u)
            v = v + mask * (v_s - v)
        return u, v

    return jax.lax.fori_loop(0, iters, sweep, (t.u0, t.v0))


def _use_sor_kernel(cfg: DenseFlowConfig, masked: bool) -> bool:
    """The fused kernel covers the plain data term on a GPU; the census
    term and the anchored pass's data mask stay on the XLA loop."""
    if cfg.sor_engine == "xla" or cfg.census_weight > 0.0 or masked:
        return False
    if cfg.sor_engine != "auto":
        raise ValueError(f"unknown sor_engine {cfg.sor_engine!r}")
    return jax.default_backend() == "gpu"


def _linearise(i1, i2w, flow, data_mask=None) -> Linearised:
    """Linearised brightness and gradient-constancy (Brox) terms of the
    warped pair around `flow`.

    data_mask: optional (H, W) float in {0, 1} — pixels with 0 get NO
    data term (all 8 linearization coefficient planes zeroed), so the
    point solve degenerates to the pure smoothness neighbor average
    there: anchored interpolation from the mask-1 pixels (the
    cfg.anchor_ambiguous pass, flow/relock.py).
    """
    g1x, g1y = _gradients(i1)
    ix, iy = _gradients(i2w)
    it = i2w - i1
    # Second derivatives of the warped image linearize the gradient
    # residuals.
    g2x, g2y = ix, iy
    gtx = g2x - g1x
    gty = g2y - g1y
    ixx, ixy = _gradients(g2x)
    _, iyy = _gradients(g2y)
    u0 = flow[..., 0]
    v0 = flow[..., 1]
    c = it - ix * u0 - iy * v0
    cgx = gtx - ixx * u0 - ixy * v0
    cgy = gty - ixy * u0 - iyy * v0
    if data_mask is not None:
        ix = ix * data_mask
        iy = iy * data_mask
        c = c * data_mask
        ixx = ixx * data_mask
        ixy = ixy * data_mask
        iyy = iyy * data_mask
        cgx = cgx * data_mask
        cgy = cgy * data_mask
    return Linearised(ix, iy, it, ixx, ixy, iyy, gtx, gty, u0, v0,
                      c, cgx, cgy)


def _census_term(i1, i2w, flow, cfg: DenseFlowConfig, data_mask=None):
    """(du, dv) -> the census channels' increments to the 2x2 system."""
    eps2 = cfg.eps * cfg.eps
    cen1 = _census_channels(i1, cfg.census_sigma)
    cen2w = _census_channels(i2w, cfg.census_sigma)
    cjx, cjy = _gradients(cen2w)       # (8, H, W)
    cct = cen2w - cen1                  # temporal census residual
    ccc = cct - cjx * flow[..., 0] - cjy * flow[..., 1]  # constant part
    if data_mask is not None:
        cjx = cjx * data_mask
        cjy = cjy * data_mask
        ccc = ccc * data_mask

    def census(du, dv):
        # Per-channel Charbonnier weights on the 8 census residuals.
        rc = cjx * du + cjy * dv + cct
        wc = cfg.census_weight / jnp.sqrt(rc * rc + eps2)
        return (jnp.sum(wc * cjx * cjx, axis=0),
                jnp.sum(wc * cjx * cjy, axis=0),
                jnp.sum(wc * cjy * cjy, axis=0),
                jnp.sum(wc * cjx * ccc, axis=0),
                jnp.sum(wc * cjy * ccc, axis=0))

    return census


def _level_solve(i1, i2, flow, cfg: DenseFlowConfig, *,
                 finest: bool = True, data_mask=None):
    """Warping + red-black SOR solves at one pyramid level (data_mask: see
    _linearise)."""
    warps = cfg.warps if finest or cfg.warps_coarse <= 0 else \
        cfg.warps_coarse
    iters = cfg.iters if finest or cfg.iters_coarse <= 0 else \
        cfg.iters_coarse

    if cfg.gain_correct:
        b1 = _gauss_blur(_gauss_blur(_gauss_blur(_gauss_blur(i1))))
    for _ in range(warps):
        with jax.named_scope("flow_warp"):
            i2w = _warp(i2, flow)
        if cfg.gain_correct:
            # Aligned-pair gain refinement: the residual illumination field
            # at this level's grid scale (clipped so true intensity
            # differences — movers, occlusions — are not erased).
            b2 = _gauss_blur(_gauss_blur(_gauss_blur(_gauss_blur(i2w))))
            i2w = i2w * jnp.clip((b1 + 1e-2) / (b2 + 1e-2), 0.7, 1.4)
        with jax.named_scope("flow_linearise"):
            lin = _linearise(i1, i2w, flow, data_mask)
            census = (_census_term(i1, i2w, flow, cfg, data_mask)
                      if cfg.census_weight > 0.0 else None)
        with jax.named_scope("flow_sor"):
            if _use_sor_kernel(cfg, data_mask is not None):
                from rs_sfm_tpu.ops import sor_cuda

                u, v = sor_cuda.sor_sweeps(lin, iters, cfg)
            else:
                u, v = sor_sweeps_xla(lin, iters, cfg, census=census)
        flow = jnp.stack([u, v], axis=-1)
        if cfg.median:
            with jax.named_scope("flow_median"):
                flow = _median_flow(flow)
    return flow


class FlowAux(NamedTuple):
    flow: jax.Array       # (H, W, 2) pixel flow
    ambiguous: jax.Array  # (H, W) bool — discrete matching found no
    #                       informative lock (periodic/flat texture); the
    #                       variational continuation filled these pixels
    alt_flow: jax.Array = None  # (H, W, 2) best >=2 px-away ALTERNATIVE
    #                       discrete lock from the finest searched scale,
    #                       upsampled to full res (full-res pixel units).
    #                       On periodic texture (alt − flow) ≈ ±one
    #                       image-space period vector (flow/relock.py)


def _upsample_mask(mask, shape):
    return jax.image.resize(mask.astype(jnp.float32), shape,
                            method="nearest") > 0.5


@functools.partial(jax.jit, static_argnames=("cfg", "has_prior"))
def _dense_flow_aux(image1, image2, cfg: DenseFlowConfig, prior=None,
                    has_prior: bool = False):
    with jax.named_scope("flow_pyramid"):
        return _dense_flow_levels(image1, image2, cfg, prior, has_prior)


def _dense_flow_levels(image1, image2, cfg, prior, has_prior):
    i1 = _to_gray(jnp.asarray(image1))
    i2 = _to_gray(jnp.asarray(image2))
    if cfg.lcn > 0.0:
        i1 = _local_contrast_norm(i1, cfg.lcn)
        i2 = _local_contrast_norm(i2, cfg.lcn)
    if cfg.struct_texture > 0.0:
        i1 = i1 - cfg.struct_texture * _gauss_blur(_gauss_blur(i1))
        i2 = i2 - cfg.struct_texture * _gauss_blur(_gauss_blur(i2))
    h, w = i1.shape

    # Pyramid (level 0 = full resolution).
    levels = cfg.levels
    max_levels = 1
    mh, mw = h, w
    while min(mh, mw) >= 24 and max_levels < levels:
        mh, mw = mh // 2, mw // 2
        max_levels += 1
    p1, p2 = [i1], [i2]
    for _ in range(max_levels - 1):
        p1.append(_downsample(p1[-1]))
        p2.append(_downsample(p2[-1]))
    priors = [None] * max_levels
    if has_prior:
        # Prior pyramid: blur-downsampled like the images, flow VALUES
        # halving per level (pixel units of that level).
        pr = jnp.asarray(prior, i1.dtype)
        priors[0] = pr
        for lv in range(1, max_levels):
            pr = jnp.stack([_downsample(pr[..., 0]),
                            _downsample(pr[..., 1])], axis=-1) * 0.5
            priors[lv] = pr

    # Ambiguity export: OR across the searched discrete scales.  The
    # periodicity of the reptex family is visible at SOME scales and not
    # others (the period must be resolvable AND inside the search
    # diameter — measured per-stage fractions 0.35/0.41/0.12 on reptex),
    # so any-scale ambiguity is the conservative anchor-exclusion signal.
    amb_full = jnp.zeros((h, w), bool)
    amb_lv = None  # current level's ambiguity (for the anchored pass)
    alt_full = None  # alternative lock, per-pixel from the FINEST scale
    #                  that flagged it ambiguous (coarser scales see the
    #                  period the fine windows cannot contain)
    if cfg.init_search_radius > 0:
        with jax.named_scope("flow_match"):
            flow, alt_c, amb_lv = _coarse_init(
                p1[-1], p2[-1], cfg.init_search_radius, cfg,
                prior=priors[-1])
        amb_full = _upsample_mask(amb_lv, (h, w))
        alt_full = jnp.where(amb_full[..., None],
                             _upsample_flow(alt_c, (h, w)),
                             jnp.zeros((h, w, 2), i1.dtype))
    else:
        flow = jnp.zeros(p1[-1].shape + (2,), i1.dtype)
    for lvl in range(max_levels - 1, -1, -1):
        shape_l = p1[lvl].shape
        if lvl != max_levels - 1:
            flow = _upsample_flow(flow, shape_l)
            if amb_lv is not None:
                amb_lv = _upsample_mask(amb_lv, shape_l)
        if lvl != 0:
            if (cfg.refine_search_radius > 0
                    and min(shape_l) <= cfg.refine_max_size):
                radius = cfg.refine_search_radius
            else:
                radius = cfg.refine_fine_radius
            if radius > 0:
                with jax.named_scope("flow_match"):
                    flow, alt, amb = _discrete_refine(
                        p1[lvl], p2[lvl], flow, radius, cfg,
                        prior=priors[lvl])
                amb_up = _upsample_mask(amb, (h, w))
                amb_full = amb_full | amb_up
                amb_lv = amb if amb_lv is None else (amb_lv | amb)
                alt_up = _upsample_flow(alt, (h, w))
                alt_full = (jnp.where(amb_up[..., None], alt_up, alt_full)
                            if alt_full is not None else alt_up)
        data_mask = None
        if cfg.anchor_ambiguous and amb_lv is not None:
            data_mask = 1.0 - amb_lv.astype(i1.dtype)
        flow = _level_solve(p1[lvl], p2[lvl], flow, cfg,
                            finest=(lvl == 0), data_mask=data_mask)
    if alt_full is None:
        alt_full = flow
    return FlowAux(flow=flow, ambiguous=amb_full, alt_flow=alt_full)


def dense_flow_aux(image1, image2, cfg: DenseFlowConfig = DenseFlowConfig(),
                   prior=None) -> FlowAux:
    """Dense flow + the discrete-matching ambiguity mask.

    Args:
      image1, image2: (H, W[, 3]) float images in [0, 1].
      cfg: DenseFlowConfig (static).
      prior: optional (H, W, 2) pixel-flow prior (e.g. the rigid-model
        prediction from a first pass — flow/relock.py).  Discrete
        matching stages multiply each candidate's SELECTION cost by a
        penalty growing with its distance to the prior: exact photometric
        ties (periodic texture) resolve toward the prior while confident
        matches are untouched; the match_ratio fallback is bypassed (the
        prior IS the disambiguation).

    Returns:
      FlowAux(flow, ambiguous) — `ambiguous` marks pixels where every
      searched discrete scale found no informative lock (best within 10%
      of a >=2 px-away alternative): on strictly periodic texture the
      flow there is a continuation guess, not a measurement.
    """
    return _dense_flow_aux(image1, image2, cfg, prior,
                           has_prior=prior is not None)


def dense_flow(image1, image2, cfg: DenseFlowConfig = DenseFlowConfig(),
               prior=None):
    """Dense flow from image1 to image2 (pixels) — see dense_flow_aux."""
    return dense_flow_aux(image1, image2, cfg, prior=prior).flow


class FlowWithOcclusion(NamedTuple):
    flow: jax.Array       # (H, W, 2) forward flow (frame1 → frame2)
    backward: jax.Array   # (H, W, 2) backward flow (frame2 → frame1)
    occlusion: jax.Array  # (H, W) bool — True where forward flow is
    #                       unreliable (occluded / out-of-view / mismatched)
    ambiguous: jax.Array = None  # (H, W) bool — discrete matching found
    #                       no informative lock (see FlowAux); None on
    #                       pre-r5 pickles only
    alt_flow: jax.Array = None  # (H, W, 2) alternative discrete lock
    #                       (FlowAux.alt_flow) of the FORWARD flow


@functools.partial(jax.jit, static_argnames=("cfg", "_has_prior"))
def _flow_fb_jit(image1, image2, cfg, prior, _has_prior):
    fw_aux = _dense_flow_aux(image1, image2, cfg, prior,
                             has_prior=_has_prior)
    fw = fw_aux.flow
    if cfg.backward_scale > 1:
        if cfg.backward_scale & (cfg.backward_scale - 1):
            raise ValueError(
                f"backward_scale must be a power of two (got "
                f"{cfg.backward_scale}): it is realized as log2(scale) "
                f"pyramid downsamples")
        g1 = _to_gray(jnp.asarray(image1))
        g2 = _to_gray(jnp.asarray(image2))
        bw_prior = (-jnp.asarray(prior, fw.dtype)
                    if _has_prior else None)
        for _ in range(cfg.backward_scale.bit_length() - 1):
            g1, g2 = _downsample(g1), _downsample(g2)
            if bw_prior is not None:
                bw_prior = jnp.stack([_downsample(bw_prior[..., 0]),
                                      _downsample(bw_prior[..., 1])],
                                     axis=-1) * 0.5
        bw_lo = _dense_flow_aux(g2, g1, cfg, bw_prior,
                                has_prior=_has_prior).flow
        bw = _upsample_flow(bw_lo, fw.shape[:2])
    else:
        # Backward prior: the negated forward prior is only an ANCHOR for
        # tie-breaking (sampled at the same pixel instead of the
        # displaced one — exact enough for disambiguation).
        bw = _dense_flow_aux(
            image2, image1, cfg,
            -jnp.asarray(prior, fw.dtype) if _has_prior else None,
            has_prior=_has_prior).flow
    with jax.named_scope("fb_occlusion"):
        return _fb_occlusion(image1, image2, cfg, fw_aux, bw)


def _fb_occlusion(image1, image2, cfg, fw_aux, bw):
    fw = fw_aux.flow
    # Backward flow sampled at x + w_f(x), channel-wise.
    bw_at_fw = jnp.stack([_warp(bw[..., 0], fw),
                          _warp(bw[..., 1], fw)], axis=-1)
    rt = fw + bw_at_fw        # round-trip residual
    sq = jnp.sum(rt * rt, axis=-1)
    mag = (jnp.sum(fw * fw, axis=-1)
           + jnp.sum(bw_at_fw * bw_at_fw, axis=-1))
    occ = sq > cfg.occ_rel * mag + cfg.occ_abs
    if cfg.occ_photo > 0.0:
        n1 = _local_contrast_norm(_to_gray(jnp.asarray(image1)), 0.05)
        n2 = _local_contrast_norm(_to_gray(jnp.asarray(image2)), 0.05)
        n2w = _warp(n2, fw)
        occ = occ | (jnp.abs(n2w - n1) > cfg.occ_photo)
    return FlowWithOcclusion(flow=fw, backward=bw, occlusion=occ,
                             ambiguous=fw_aux.ambiguous,
                             alt_flow=fw_aux.alt_flow)


def flow_forward_backward(image1, image2,
                          cfg: DenseFlowConfig = DenseFlowConfig(),
                          prior=None) -> FlowWithOcclusion:
    """Forward + backward flow with occlusion detection.

    The forward-backward consistency check (Sundaram-Brox): a pixel x is
    occluded (or mismatched) when the round trip does not return,
      |w_f(x) + w_b(x + w_f(x))|² > 0.01·(|w_f(x)|² + |w_b(x+w_f)|²) + 0.5.
    The reference has no occlusion handling (DeepFlow output is consumed
    raw, src/camera.cc:253-277); its report names occlusion-induced flow
    failure as the dominant real-world error mode (example 4).  The mask
    feeds `estimate_from_flow(..., pixel_mask=~occlusion)` so RANSAC and
    refinement never score occluded pixels.

    The result additionally carries the discrete-matching `ambiguous`
    mask (see dense_flow_aux): periodic-texture pixels the FB test CANNOT
    flag (the wrong lock round-trips consistently).  `prior` is the
    optional rigid-model flow prior for the relock pass (flow/relock.py);
    the backward solve uses its negation as a tie-break anchor.
    """
    return _flow_fb_jit(image1, image2, cfg, prior,
                        _has_prior=prior is not None)
