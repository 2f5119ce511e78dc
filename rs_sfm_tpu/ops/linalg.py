"""Batched small-matrix linear algebra as pure elementwise JAX.

Everything here operates on stacks of tiny matrices ((..., n, n) with n ≤ ~16)
and is designed for the solver hot loop: thousands of RANSAC hypotheses solved
in parallel (reference runs 5 sequential Eigen solves instead —
src/minimal.cc:230-247).  All loops over matrix indices are static Python
loops (unrolled at trace time), so the generated XLA is straight-line
elementwise code that vectorizes trivially over the batch.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Gram sums over pixels
# ---------------------------------------------------------------------------


def gram(x):
    """XᵀX of a tall (..., n) stack, summed over every leading axis.

    An elementwise product and a reduction rather than a matrix product:
    the products are exact in float32 (no TF32 or bf16 passes), and XLA
    fuses the whole sum into one reduction.  As a dot, the same sum over
    millions of rows, vmapped over a few multi-start problems, becomes a
    batched GEMM with a contraction of millions that cuBLAS runs ~45 ms a
    call on an H100 (PERF.md).
    """
    return jnp.sum(x[..., :, None] * x[..., None, :],
                   axis=tuple(range(x.ndim - 1)))


# ---------------------------------------------------------------------------
# Symmetric eigendecomposition: cyclic Jacobi
# ---------------------------------------------------------------------------


def _jacobi_rotate(a, v, p, q):
    """One Jacobi rotation zeroing a[..., p, q] (p < q static ints)."""
    apq = a[..., p, q]
    app = a[..., p, p]
    aqq = a[..., q, q]
    small = jnp.abs(apq) <= jnp.finfo(a.dtype).tiny * 1e3
    safe_apq = jnp.where(small, jnp.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    # sign(0) == 0 would zero the rotation; tau == 0 must give t = 1.
    t = jnp.where(tau == 0.0, jnp.ones_like(t), t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(small, jnp.ones_like(c), c)
    s = jnp.where(small, jnp.zeros_like(s), s)

    ce = c[..., None]
    se = s[..., None]
    # Rows: A <- Jᵀ A
    row_p = a[..., p, :]
    row_q = a[..., q, :]
    a = a.at[..., p, :].set(ce * row_p - se * row_q)
    a = a.at[..., q, :].set(se * row_p + ce * row_q)
    # Cols: A <- A J
    col_p = a[..., :, p]
    col_q = a[..., :, q]
    a = a.at[..., :, p].set(ce * col_p - se * col_q)
    a = a.at[..., :, q].set(se * col_p + ce * col_q)
    # Exact zeros on the annihilated pair keep the off-diagonal decaying.
    a = a.at[..., p, q].set(jnp.zeros_like(apq))
    a = a.at[..., q, p].set(jnp.zeros_like(apq))
    # Eigenvector accumulation: V <- V J
    vp = v[..., :, p]
    vq = v[..., :, q]
    v = v.at[..., :, p].set(ce * vp - se * vq)
    v = v.at[..., :, q].set(se * vp + ce * vq)
    return a, v


def eigh_small(a, sweeps: int | None = None):
    """Eigendecomposition of symmetric matrices by cyclic Jacobi.

    Args:
      a: (..., n, n) symmetric.
      sweeps: number of full cyclic sweeps (default: enough for n ≤ 9 to reach
        close-to-machine precision; Jacobi converges quadratically).

    Returns:
      (eigenvalues (..., n) ascending, eigenvectors (..., n, n) with
      eigenvectors in columns) — same contract as jnp.linalg.eigh.
    """
    n = a.shape[-1]
    if sweeps is None:
        sweeps = 8 if n <= 4 else 12
    a = (a + jnp.swapaxes(a, -1, -2)) * 0.5
    # Derive the identity init from `a` (not broadcast_to) so its sharding
    # metadata matches inside shard_map'ed loop carries.
    v = jnp.zeros_like(a) + jnp.eye(n, dtype=a.dtype)

    def sweep(_, av):
        a, v = av
        for p in range(n - 1):
            for q in range(p + 1, n):
                a, v = _jacobi_rotate(a, v, p, q)
        return a, v

    a, v = jax.lax.fori_loop(0, sweeps, sweep, (a, v))
    w = jnp.diagonal(a, axis1=-2, axis2=-1)
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    v = jnp.take_along_axis(v, order[..., None, :], axis=-1)
    return w, v


def null_vector(z):
    """Right-singular vector of z for the smallest singular value.

    The reference extracts it with JacobiSVD (src/minimal.cc:98-101); here it
    is the eigenvector of zᵀz for the smallest eigenvalue — identical vector
    (up to sign), and eigh of a 9x9 symmetric matrix batches perfectly.

    Args:
      z: (..., m, n) with m >= n.

    Returns:
      (..., n) unit vector spanning the (approximate) null space.
    """
    # HIGHEST: a default-precision f32 product may run in TF32 (10-bit
    # mantissa operands); the null space of ZᵀZ is precisely where that
    # truncation destroys the answer in f32.
    ztz = jnp.einsum("...ij,...ik->...jk", z, z,
                     precision=jax.lax.Precision.HIGHEST)
    _, v = eigh_small(ztz)
    return v[..., :, 0]


# ---------------------------------------------------------------------------
# Gaussian elimination with partial pivoting (batched, unrolled)
# ---------------------------------------------------------------------------


def _pivot_swap(a, k, det_sign=None):
    """Swap row k with the largest-|a[:, k]| row below it (batched)."""
    n = a.shape[-2]
    col = jnp.abs(a[..., :, k])
    row_ids = jnp.arange(n)
    col = jnp.where(row_ids >= k, col, -jnp.ones_like(col))
    piv = jnp.argmax(col, axis=-1)  # (...,)
    piv_b = piv[..., None, None]
    p_row = jnp.take_along_axis(a, jnp.broadcast_to(piv_b, a.shape[:-2] + (1, a.shape[-1])), axis=-2)
    p_row = p_row[..., 0, :]
    k_row = a[..., k, :]
    a = a.at[..., k, :].set(p_row)
    # Scatter the old row k into the pivot position (no-op when piv == k,
    # because p_row == k_row in that case).
    mask = (row_ids[:, None] == piv[..., None, None])  # (..., n, 1)
    a = jnp.where(mask, k_row[..., None, :], a)
    if det_sign is not None:
        det_sign = det_sign * jnp.where(piv == k, 1.0, -1.0).astype(det_sign.dtype)
        return a, det_sign
    return a


def gauss_det(a):
    """Determinant of (..., n, n) via partially pivoted elimination."""
    n = a.shape[-1]
    sign = jnp.ones(a.shape[:-2], dtype=a.dtype)
    for k in range(n - 1):
        a, sign = _pivot_swap(a, k, sign)
        pivval = a[..., k, k]
        safe = jnp.where(pivval == 0.0, jnp.ones_like(pivval), pivval)
        factors = a[..., :, k] / safe[..., None]
        row_ids = jnp.arange(n)
        factors = jnp.where(row_ids > k, factors, jnp.zeros_like(factors))
        a = a - factors[..., None] * a[..., k, :][..., None, :]
        # A zero pivot after pivoting means the matrix is singular: det = 0
        # falls out naturally because the diagonal keeps the zero.
        a = a.at[..., k, k].set(pivval)
    diag = jnp.diagonal(a, axis1=-2, axis2=-1)
    return sign * jnp.prod(diag, axis=-1)


def gauss_solve(a, b):
    """Solve a @ x = b for tiny batched systems.

    Args:
      a: (..., n, n)
      b: (..., n) or (..., n, m)

    Returns:
      x with the shape of b.
    """
    vec = b.ndim == a.ndim - 1
    if vec:
        b = b[..., None]
    n = a.shape[-1]
    aug = jnp.concatenate([a, b], axis=-1)
    for k in range(n):
        aug = _pivot_swap(aug, k)
        pivval = aug[..., k, k]
        safe = jnp.where(pivval == 0.0, jnp.ones_like(pivval), pivval)
        aug = aug.at[..., k, :].set(aug[..., k, :] / safe[..., None])
        factors = aug[..., :, k]
        row_ids = jnp.arange(n)
        factors = jnp.where(row_ids == k, jnp.zeros_like(factors), factors)
        aug = aug - factors[..., None] * aug[..., k, :][..., None, :]
    x = aug[..., n:]
    return x[..., 0] if vec else x


def gauss_inv(a):
    """Inverse of tiny batched matrices via Gauss-Jordan."""
    n = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)
    return gauss_solve(a, eye)


def solve_spd(a, b, damping=0.0):
    """Solve a symmetric positive-definite system (a + damping*I) x = b.

    Used for the reduced 7x7 Schur system in the joint refinement.  Uses the
    pivoted solver: at n=7 the cost difference vs Cholesky is irrelevant and
    pivoting is more forgiving near rank deficiency.
    """
    n = a.shape[-1]
    if damping is not None:
        a = a + damping * jnp.eye(n, dtype=a.dtype)
    return gauss_solve(a, b)


def solve_pd_nopivot(a, b):
    """Solve a @ x = b without pivoting (tiny positive-definite systems).

    For LM-damped normal equations the diagonal dominates, so partial
    pivoting is unnecessary; dropping it roughly halves the op count of the
    unrolled elimination — this matters when the solve sits inside a
    sequential 50-iteration device loop where per-op dispatch dominates
    (the reference leaves this to Ceres' dense Cholesky,
    src/nonlinearRefinement.cc:161).

    Args:
      a: (..., n, n) damped PD matrix.
      b: (..., n) or (..., n, m).

    Returns:
      x with the shape of b.
    """
    vec = b.ndim == a.ndim - 1
    if vec:
        b = b[..., None]
    n = a.shape[-1]
    aug = jnp.concatenate([a, b], axis=-1)
    row_ids = jnp.arange(n)
    for k in range(n):
        pivval = aug[..., k, k]
        safe = jnp.where(pivval == 0.0, jnp.ones_like(pivval), pivval)
        factors = jnp.where(row_ids == k, jnp.zeros_like(aug[..., :, k]),
                            aug[..., :, k])
        piv_row = aug[..., k, :] / safe[..., None]
        aug = jnp.where((row_ids == k)[:, None], piv_row[..., None, :],
                        aug - factors[..., None] * piv_row[..., None, :])
    x = aug[..., n:]
    return x[..., 0] if vec else x


# ---------------------------------------------------------------------------
# Polynomial roots: Durand–Kerner (Weierstrass) simultaneous iteration
# ---------------------------------------------------------------------------


def polyroots(coeffs, iterations: int = 64):
    """All complex roots of a polynomial, batched.

    Args:
      coeffs: (..., n+1) real coefficients, ascending order
        (c[0] + c[1] x + ... + c[n] x^n).  The leading coefficient must be
        nonzero for meaningful results; near-zero leading coefficients
        produce huge-magnitude roots, which downstream min-|k| selection
        discards naturally.
      iterations: Durand–Kerner iterations (quadratic convergence; 64 is
        far past machine precision for degree <= 6).

    Returns:
      (roots_re, roots_im): each (..., n).
    """
    c = coeffs
    deg = c.shape[-1] - 1
    lead = c[..., -1]
    safe_lead = jnp.where(jnp.abs(lead) < jnp.finfo(c.dtype).tiny * 1e6,
                          jnp.ones_like(lead), lead)
    monic = c / safe_lead[..., None]  # (..., n+1), leading coeff 1

    # Cauchy-style radius: 1 + max |c_i| of the monic polynomial.
    radius = 1.0 + jnp.max(jnp.abs(monic[..., :-1]), axis=-1)
    angles = 2.0 * np.pi * np.arange(deg) / deg + 0.4
    init_re = radius[..., None] * jnp.asarray(np.cos(angles), dtype=c.dtype)
    init_im = radius[..., None] * jnp.asarray(np.sin(angles), dtype=c.dtype)

    def poly_eval(re, im):
        """Horner evaluation of the monic polynomial at re + i*im."""
        pr = jnp.ones_like(re)
        pi = jnp.zeros_like(im)
        for j in range(deg - 1, -1, -1):
            pr, pi = (pr * re - pi * im + monic[..., j][..., None],
                      pr * im + pi * re)
        return pr, pi

    def step(_, roots):
        re, im = roots
        pr, pi = poly_eval(re, im)
        # denominator: prod over m != j of (z_j - z_m)
        dre = re[..., :, None] - re[..., None, :]
        dim = im[..., :, None] - im[..., None, :]
        eye = jnp.eye(deg, dtype=c.dtype)
        dre = dre + eye  # diagonal -> 1 + 0i (excluded from the product)
        prod_re = jnp.ones_like(re)
        prod_im = jnp.zeros_like(im)
        for m in range(deg):
            a, b = dre[..., :, m], dim[..., :, m]
            prod_re, prod_im = prod_re * a - prod_im * b, prod_re * b + prod_im * a
        # delta = p(z) / prod
        den = prod_re * prod_re + prod_im * prod_im
        den = jnp.where(den == 0.0, jnp.ones_like(den), den)
        delta_re = (pr * prod_re + pi * prod_im) / den
        delta_im = (pi * prod_re - pr * prod_im) / den
        return re - delta_re, im - delta_im

    re, im = jax.lax.fori_loop(0, iterations, step, (init_re, init_im))
    return re, im
