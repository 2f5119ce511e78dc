"""Batched 9-point differential RS epipolar minimal solver.

Recovers (v, w, k) from 9 normalized point/flow correspondences via the RS
differential epipolar constraint  uᵀ v̂ x + β·xᵀ S x = 0  with
S = ½(v̂ŵ + ŵv̂) (report eq. 14, 21), following the linear differential
algorithm of Ma/Košecká/Sastry plus the project's own k-from-det(Z(k))
elimination (reference src/minimal.cc:36-177).

Every step is a tiny fixed-shape matrix computation built
on ops.linalg, so the whole solver vmaps over thousands of RANSAC hypotheses
in one fused pass (the reference runs one Eigen solve per sequential trial).
Leading batch axes broadcast throughout.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from rs_sfm_tpu.geom import so3
from rs_sfm_tpu.ops import linalg

# Tolerances mirroring the reference (src/minimal.cc:39-40).
_THRESHOLD_LAMBDA = 1e-6
_TOL_IMAG = 1e-5

# Nodes for exact recovery of the degree-6 polynomial det(p - λ·p_k):
# 7 Chebyshev points on [-3, 3]; the inverse Vandermonde is a compile-time
# constant.
_K_NODES = 3.0 * np.cos(np.pi * (2 * np.arange(7) + 1) / 14.0)
_INV_VANDERMONDE = np.linalg.inv(np.vander(_K_NODES, 7, increasing=True))


def _highest_matmul(fn):
    """Run fn with HIGHEST matmul precision: the tiny-matrix chains here
    are cancellation-sensitive, and reduced-precision operands (bf16 or
    TF32 products) measurably break the f32 k-path."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def build_z_columns(q, u):
    """Unscaled rows of the 9x9 Z matrix (src/minimal.cc:47-54).

    Args:
      q: (..., 9, 2) normalized coordinates, u: (..., 9, 2) normalized flow.

    Returns:
      (..., 9, 9): columns [−u_y, u_x, u_y·x − u_x·y, x², 2xy, 2x, y², 2y, 1];
      columns 3..8 still lack their per-row β scaling.
    """
    x, y = q[..., 0], q[..., 1]
    ux, uy = u[..., 0], u[..., 1]
    one = jnp.ones_like(x)
    return jnp.stack(
        [
            -uy,
            ux,
            uy * x - ux * y,
            x * x,
            2.0 * x * y,
            2.0 * x,
            y * y,
            2.0 * y,
            one,
        ],
        axis=-1,
    )


def estimate_k_roots(z, alpha, alpha_k):
    """All candidate k roots of det(Z(k)) = 0 (degree-6 polynomial).

    Returns (roots_re, roots_im): each (..., 6).  See estimate_k for the
    derivation.  On a noise-free minimal sample the polynomial typically has
    several real roots — every one of them interpolates the 9 constraints
    exactly; only scoring against the full pixel set (RANSAC) identifies the
    physical one.

    Two root engines, selected by dtype:
      * float64: exact degree-6 polynomial recovery (7 determinant nodes +
        inverse Vandermonde) rooted with Durand–Kerner — the path verified
        bit-close against the reference binary (tests/test_parity_reference).
      * float32: the polynomial-coefficient recovery is catastrophically
        ill-conditioned in single precision (measured: k̂ off by
        ±5), so candidates come from Newton iteration on det(M(κ)) = 0
        directly, using Jacobi's formula
            d/dκ log det(M) = tr(M⁻¹ p_k)  ⇒  Newton step Δκ = −1/tr(M⁻¹p_k)
        — no determinants, hence no dynamic-range problem.  Six fixed
        starts cover the physically plausible range; non-converged starts
        are flagged imaginary so the existing real-root filters drop them.
    """
    dtype = z.dtype
    # f32 hazard (measured: k roots turn to garbage at reduced matmul
    # precision): every matmul in these chains runs HIGHEST.
    p, p_k = _k_pencil(z, alpha, alpha_k)
    if dtype == jnp.float64:
        return _k_roots_polynomial(p, p_k, dtype)
    return _k_roots_newton(p, p_k, dtype)


@_highest_matmul
def _k_pencil(z, alpha, alpha_k):
    """The 6x6 pencil (p, p_k) with det(Z(k)) ∝ det(p + k·p_k)."""
    a = z[..., :3, :3]
    bc = z[..., :3, 3:]
    dg = z[..., 3:, :3]
    efhj = z[..., 3:, 3:]
    a_inv = linalg.gauss_inv(a)
    dga = jnp.einsum("...ij,...jk->...ik", dg, a_inv)
    p = alpha[..., 3:, None] * efhj - jnp.einsum(
        "...ik,...k,...kl->...il", dga, alpha[..., :3], bc)
    p_k = alpha_k[..., 3:, None] * efhj - jnp.einsum(
        "...ik,...k,...kl->...il", dga, alpha_k[..., :3], bc)
    return p, p_k


@_highest_matmul
def _k_roots_polynomial(p, p_k, dtype):
    # det(p + κ·p_k) evaluated at the 7 fixed nodes; the degree-6 polynomial
    # is recovered exactly through the precomputed inverse Vandermonde.
    nodes = jnp.asarray(_K_NODES, dtype=dtype)
    dets = jnp.stack(
        [linalg.gauss_det(p + nodes[i] * p_k) for i in range(7)], axis=-1
    )
    scale = jnp.max(jnp.abs(dets), axis=-1, keepdims=True)
    scale = jnp.where(scale == 0.0, jnp.ones_like(scale), scale)
    coeffs = jnp.einsum(
        "ij,...j->...i", jnp.asarray(_INV_VANDERMONDE, dtype=dtype), dets / scale
    )
    return linalg.polyroots(coeffs)


# Newton starts for the f32 root engine: cover the physically plausible k
# range (β's pole sits at k = −2; |k| beyond ~3 is outside any RS video
# regime and the reference's sweeps stop at 1.5).
_K_NEWTON_STARTS = np.array([-1.5, -0.75, 0.0, 0.5, 1.0, 1.75])
_K_NEWTON_ITERS = 12


@_highest_matmul
def _k_roots_newton(p, p_k, dtype):
    starts = jnp.asarray(_K_NEWTON_STARTS, dtype=dtype)
    batch = p.shape[:-2]
    k = jnp.broadcast_to(starts, batch + (6,))

    def body(_, k):
        m = p[..., None, :, :] + k[..., None, None] * p_k[..., None, :, :]
        m_inv = linalg.gauss_inv(m)
        tr = jnp.einsum("...ij,...ji->...", m_inv,
                        p_k[..., None, :, :],
                        precision=jax.lax.Precision.HIGHEST)
        safe = jnp.where(jnp.abs(tr) < 1e-20, jnp.ones_like(tr), tr)
        step = -1.0 / safe
        # Damp huge steps (near-critical points of det): cap at 1.0.
        step = jnp.clip(step, -1.0, 1.0)
        return jnp.where(jnp.abs(tr) < 1e-20, k, k + step)

    k = jax.lax.fori_loop(0, _K_NEWTON_ITERS, body, k)
    # Convergence check: one more Newton step must be tiny relative to k.
    m = p[..., None, :, :] + k[..., None, None] * p_k[..., None, :, :]
    m_inv = linalg.gauss_inv(m)
    tr = jnp.einsum("...ij,...ji->...", m_inv, p_k[..., None, :, :],
                    precision=jax.lax.Precision.HIGHEST)
    safe = jnp.where(jnp.abs(tr) < 1e-20, jnp.ones_like(tr), tr)
    last = jnp.abs(1.0 / safe)
    ok = (last < 1e-3 * (1.0 + jnp.abs(k))) & jnp.isfinite(k)
    roots_re = jnp.where(ok, k, jnp.zeros_like(k))
    # Non-converged starts are flagged via a large fake imaginary part so
    # the shared real-root filters (|imag| < _TOL_IMAG) reject them.
    roots_im = jnp.where(ok, jnp.zeros_like(k), jnp.ones_like(k))
    return roots_re, roots_im


def estimate_k(z, alpha, alpha_k, compat_negate: bool = False):
    """Estimate the acceleration factor k from det(Z(k)) = 0.

    Reduction (src/minimal.cc:56-83): with a = Z[:3,:3], bc = Z[:3,3:],
    dg = Z[3:,:3], efhj = Z[3:,3:], the Schur complement of `a` in Z(k) is
    p + k·p_k where
       p   = diag(α₄..₉)·efhj − dg·a⁻¹·diag(α₁..₃)·bc,
       p_k = diag(α̃₄..₉)·efhj − dg·a⁻¹·diag(α̃₁..₃)·bc,
    so det(Z(k)) = det(a)·det(p + k·p_k) and admissible k are the real roots
    of the degree-6 polynomial det(p + k·p_k).

    The reference instead takes k as an eigenvalue of p·p_k⁻¹
    (src/minimal.cc:70-80), which equals −root; pass compat_negate=True to
    reproduce that behavior.  Instead of a general nonsymmetric
    eigensolver (XLA has none on accelerators), the polynomial is
    recovered exactly from 7 determinant
    evaluations (fixed inverse Vandermonde) and rooted with Durand–Kerner.

    Selection follows the reference: real roots only (|imag| < 1e-5), the one
    of smallest magnitude; if none qualifies, k = 0 (the reference leaves
    k = ∞ and produces NaNs downstream — src/minimal.cc:75-80 — which can
    never win RANSAC, so 0 is an equivalent safe sentinel).
    """
    roots_re, roots_im = estimate_k_roots(z, alpha, alpha_k)
    is_real = jnp.abs(roots_im) < _TOL_IMAG
    finite = jnp.isfinite(roots_re)
    valid = is_real & finite
    mag = jnp.where(valid, jnp.abs(roots_re), jnp.inf)
    best = jnp.argmin(mag, axis=-1)
    k = jnp.take_along_axis(roots_re, best[..., None], axis=-1)[..., 0]
    any_valid = jnp.any(valid, axis=-1)
    k = jnp.where(any_valid, k, jnp.zeros_like(k))
    if compat_negate:
        k = -k
    return k


def _rot_y(theta):
    return so3.rot_y(theta)


@_highest_matmul
def recover_vw(z):
    """Steps 1-4 of the linear differential algorithm on a β-scaled Z.

    Args:
      z: (..., 9, 9) with columns 3..8 already scaled by per-row β.

    Returns:
      (w, v): (..., 3) each; v is the unit-normalized null-vector direction
      (globally scale/sign-ambiguous, like the reference — the pipeline's
      z-mean sign flip resolves the sign).
    """
    dtype = z.dtype
    # Step 1: null vector e, normalized by ||e[:3]|| (src/minimal.cc:98-103).
    e = linalg.null_vector(z)
    norm_v0 = jnp.sqrt(e[..., 0] ** 2 + e[..., 1] ** 2 + e[..., 2] ** 2)
    safe = jnp.where(norm_v0 == 0.0, jnp.ones_like(norm_v0), norm_v0)
    e = e / safe[..., None]
    v0 = e[..., :3]
    s = jnp.stack(
        [
            jnp.stack([e[..., 3], e[..., 4], e[..., 5]], axis=-1),
            jnp.stack([e[..., 4], e[..., 6], e[..., 7]], axis=-1),
            jnp.stack([e[..., 5], e[..., 7], e[..., 8]], axis=-1),
        ],
        axis=-2,
    )

    # Step 2: eigendecomposition of S; the algorithm wants descending order in
    # the outer columns (the reference swaps columns 0/2 of Eigen's ascending
    # result — src/minimal.cc:111-118).
    lamb, vecs = linalg.eigh_small(s)  # ascending
    v1 = jnp.stack([vecs[..., :, 2], vecs[..., :, 1], vecs[..., :, 0]], axis=-1)
    l0, l1, l2 = lamb[..., 0], lamb[..., 1], lamb[..., 2]
    sigma1 = (2.0 * l2 + l1 - l0) / 3.0
    sigma2 = (l2 + 2.0 * l1 + l0) / 3.0
    sigma3 = (-l2 + l1 + 2.0 * l0) / 3.0

    # Step 3: angle θ and the U/V bases (src/minimal.cc:120-133).
    lam = sigma1 - sigma3
    ratio = jnp.clip(-sigma2 / jnp.where(lam == 0.0, jnp.ones_like(lam), lam),
                     -1.0, 1.0)
    theta = jnp.where(lam < _THRESHOLD_LAMBDA, jnp.zeros_like(lam),
                      jnp.arccos(ratio))
    r_v = _rot_y((theta - jnp.pi) / 2.0)
    r_u = _rot_y(theta)
    v_mat = jnp.einsum("...ij,...kj->...ik", v1, r_v)  # v1 @ r_vᵀ
    u_mat = -jnp.einsum("...ij,...jk->...ik", v_mat, r_u)

    sig1 = jnp.asarray(np.diag([1.0, 1.0, 0.0]), dtype=dtype)
    rz1 = jnp.asarray(
        np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
        dtype=dtype)  # RotZ(+π/2)
    rz2 = jnp.asarray(
        np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
        dtype=dtype)  # RotZ(−π/2)

    def sandwich(mat, rz, core):
        return jnp.einsum("...ij,jk,kl,...ml->...im", mat, rz, core, mat)

    v_hat_v1 = sandwich(v_mat, rz1, sig1)
    v_hat_v2 = sandwich(v_mat, rz2, sig1)
    v_hat_u1 = sandwich(u_mat, rz1, sig1)
    v_hat_u2 = sandwich(u_mat, rz2, sig1)

    # Step 4: pick the candidate maximizing v̂ᵀ·v0 (src/minimal.cc:146-157).
    v_vecs = jnp.stack(
        [so3.vee(v_hat_v1), so3.vee(v_hat_v2), so3.vee(v_hat_u1),
         so3.vee(v_hat_u2)], axis=-2)  # (..., 4, 3)
    dots = jnp.einsum("...ci,...i->...c", v_vecs, v0)
    idx = jnp.argmax(dots, axis=-1)

    # ω pairing is crossed (src/minimal.cc:159-173): v-candidates pair with
    # U-based ŵ and vice versa; ŵ uses sig_lamb = λ·Σ1, folded in as a
    # scalar multiply below.
    w_opts = jnp.stack(
        [
            sandwich(u_mat, rz1, sig1),
            sandwich(u_mat, rz2, sig1),
            sandwich(v_mat, rz1, sig1),
            sandwich(v_mat, rz2, sig1),
        ],
        axis=-3,
    ) * lam[..., None, None, None]
    w_hat = jnp.take_along_axis(
        w_opts, idx[..., None, None, None], axis=-3)[..., 0, :, :]
    w = so3.vee(w_hat)
    return w, v0


def _beta_scale_z(z, beta):
    """β-scale columns 3..8 of Z (src/minimal.cc:89-94)."""
    return jnp.concatenate([z[..., :3], z[..., 3:] * beta[..., None]], axis=-1)


def calculate_velocities(q, u, alpha, alpha_k, use_k: bool,
                         compat_negate_k: bool = False):
    """9-point solve for (w, v, k) (reference src/minimal.cc:36-177).

    Args:
      q: (..., 9, 2) normalized coordinates of the sample.
      u: (..., 9, 2) normalized (γ-scaled) flow of the sample.
      alpha, alpha_k: (..., 9) RS correction factors of the sample.
      use_k: constant-acceleration model — estimate k by the reference's
        min-|real-root| rule (static flag).

    Returns:
      (w, v, k): (..., 3), (..., 3), (...,).
    """
    dtype = q.dtype
    z = build_z_columns(q, u)
    if use_k:
        k = estimate_k(z, alpha, alpha_k, compat_negate=compat_negate_k)
        beta = (alpha + k[..., None] * alpha_k) * (2.0 / (2.0 + k[..., None]))
    else:
        k = jnp.zeros(q.shape[:-2], dtype=dtype)
        beta = alpha
    w, v = recover_vw(_beta_scale_z(z, beta))
    return w, v, k


def calculate_velocities_all_k(q, u, alpha, alpha_k):
    """9-point solve returning one (w, v) per real k root.

    On a minimal sample *every* real root of det(Z(k)) interpolates the 9
    constraints, so the reference's min-|k| pick (src/minimal.cc:74-80) can
    select a spurious root.  This variant returns all ≤6 candidates so
    RANSAC can score each against the full pixel set — strictly stronger
    selection at negligible extra solve cost (the scoring pass dominates).

    Returns:
      (w (..., 6, 3), v (..., 6, 3), k (..., 6), valid (..., 6) bool).
      Invalid slots (complex/non-finite roots) carry k=0 and valid=False.
    """
    z = build_z_columns(q, u)
    roots_re, roots_im = estimate_k_roots(z, alpha, alpha_k)
    valid = (jnp.abs(roots_im) < _TOL_IMAG) & jnp.isfinite(roots_re)
    k = jnp.where(valid, roots_re, jnp.zeros_like(roots_re))  # (..., 6)
    beta = (alpha[..., None, :] + k[..., :, None] * alpha_k[..., None, :]) * (
        2.0 / (2.0 + k[..., :, None]))  # (..., 6, 9)
    z6 = jnp.broadcast_to(z[..., None, :, :], beta.shape[:-1] + (9, 9))
    z6 = _beta_scale_z(z6, beta)
    w, v = recover_vw(z6)
    return w, v, k, valid
