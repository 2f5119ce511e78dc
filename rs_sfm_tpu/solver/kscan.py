"""Deterministic k initialization by 1-D grid scan.

The constant-acceleration model's cost landscape over k has a mirror basin
near k ≈ −1 (β(k) = (α + k·α̃)·2/(2+k) admits a sign-flipped (v, ρ)
solution there); in float32 the LM refinement started from a noisy RANSAC
k̂ occasionally converges into it, blowing up the 3D error (ACCURACY.md).
The reference does not hit this because its k estimate comes from an exact
double-precision eigensolve (src/minimal.cc:56-83) and Ceres refines in
f64.

This module makes k selection deterministic at f32: evaluate the TRUE
refinement objective on a fixed k grid — for each k, alternate the
closed-form per-pixel depth (solver/depth.py) with the exact linear
least-squares (v, w) re-fit (the model u = β(k)(Aρ·v + B·w) is linear in
(v, w) given (k, ρ)) — and hand the grid winner to LM.  Basins are
compared by cost rather than by which one LM happens to fall into, so the
mirror basin loses whenever it is worse (which it is, up to noise).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from rs_sfm_tpu.ops import linalg
from rs_sfm_tpu.solver.beta import beta_factor
from rs_sfm_tpu.solver.depth import estimate_inverse_depth
from rs_sfm_tpu.solver.flow_model import rotational_flow, translational_flow


def _psum(x, axis_name: Optional[str]):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _fit_vw(coords, flow, alpha, alpha_k, m, rho, k, axis_name):
    """Exact linear LS for (v, w) at fixed (k, ρ).

    Design matrix per pixel: G_i = β_i·[ρ_i·A_i | B_i] (2x6); solves the
    masked normal equations Σ m GᵀG · θ = Σ m Gᵀu (one psum when pixels
    are sharded).
    """
    dt = coords.dtype
    beta = beta_factor(alpha, alpha_k, k)[..., None]  # (N, 1)
    eye = jnp.eye(3, dtype=dt)
    # Columns from the flow-model conventions themselves (no sign/layout
    # duplication): A·e_j and B·e_j for the 3 basis vectors.
    cols = ([beta * rho[..., None] * translational_flow(coords, eye[j])
             for j in range(3)]
            + [beta * rotational_flow(coords, eye[j]) for j in range(3)])
    g = jnp.stack(cols, axis=-1)  # (N, 2, 6)
    gm = g * m[..., None, None]
    aug = jnp.concatenate([gm, (flow * m[..., None])[..., None]], axis=-1)
    # Exact-product reduction, as in the refinement's Schur assembly: the
    # k valley is cancellation-sensitive.
    gram = _psum(linalg.gram(aug), axis_name)
    gtg = gram[:6, :6] + 1e-12 * jnp.eye(6, dtype=dt)
    gtu = gram[:6, 6]
    theta = linalg.gauss_solve(gtg, gtu)
    return theta[:3], theta[3:6]


def k_scan(coords, flow, alpha, alpha_k, mask, v0, w0, k_grid, *,
           iters: int = 3, axis_name: Optional[str] = None):
    """Scan the k grid; return (v, w, k, ρ, cost) of the grid winner.

    Args:
      coords, flow: (N, 2) normalized coordinates / flow.
      alpha, alpha_k: (N,) RS factors.
      mask: (N,) bool — pixels participating (RANSAC inliers).
      v0, w0: (3,) initial motion (RANSAC winner) — the alternation seed,
        which keeps the scan inside the v-basin the sample selected.
      k_grid: (K,) k values to evaluate.
      iters: alternations of closed-form ρ and linear (v, w) per k.
      axis_name: collective axis when pixels are sharded.

    Returns:
      (v (3,), w (3,), k (), rho (N,), cost ()) at the best grid point.
    """
    m = mask.astype(coords.dtype)

    def eval_k(k):
        v, w = v0, w0
        rho = estimate_inverse_depth(coords, flow, v, w, k, alpha, alpha_k)
        for _ in range(iters):
            v, w = _fit_vw(coords, flow, alpha, alpha_k, m, rho, k,
                           axis_name)
            rho = estimate_inverse_depth(coords, flow, v, w, k,
                                         alpha, alpha_k)
        beta = beta_factor(alpha, alpha_k, k)[..., None]
        r = flow - beta * (translational_flow(coords, v) * rho[..., None]
                           + rotational_flow(coords, w))
        cost = _psum(jnp.sum(m * jnp.sum(r * r, axis=-1)), axis_name)
        # Guard: non-finite alternation (singular fit) must lose the scan.
        cost = jnp.where(jnp.isfinite(cost), cost, jnp.inf)
        return cost, v, w, rho

    # Sequential over the grid (lax.map): a vmap would materialize a
    # (K, N, 2) design-matrix batch — hundreds of MB at full-HD.
    costs, vs, ws, rhos = jax.lax.map(eval_k, k_grid)
    best = jnp.argmin(costs)
    return (vs[best], ws[best], k_grid[best], rhos[best], costs[best])
