"""Joint nonlinear refinement of (v, w, k, inverse depths) by
Schur-reduced Levenberg–Marquardt.

The reference hands this to Ceres with DENSE_SCHUR
(src/nonlinearRefinement.cc:183-252): 2N residuals over parameters
{v(3), w(3), k(1), ρ_1..ρ_N}, depths initialized from RANSAC, plain L2 loss.
Here the same objective

    min Σ_i m_i · ‖u_i − β_i(k)·(A_i v ρ_i + B_i w)‖²

is minimized with a hand-rolled LM whose linear solve exploits the problem's
arrow structure analytically (the "distributed Schur" component of the
design, SURVEY.md §2.3):

  * Per-pixel 2x8 Jacobians are closed form (no autodiff tape needed).
  * The per-pixel depth blocks are scalars, so the Schur complement of the
    depth block is a 7x7 system assembled from pixel-wise reductions:
        H̃  = Σ JθᵀJθ − Σ (JθᵀJρ)(JρᵀJρ)⁻¹(JρᵀJθ)
    Every Σ is a masked sum over pixels — exactly a `psum` when pixels are
    sharded across chips (pass axis_name inside shard_map).
  * δρ_i back-substitutes per pixel.

All control flow is a fixed-iteration lax.fori_loop with accept/reject LM
damping, so the whole refinement jits into one XLA computation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from rs_sfm_tpu.ops import linalg
from rs_sfm_tpu.solver.beta import beta_factor, beta_factor_dk
from rs_sfm_tpu.solver.depth import estimate_inverse_depth_info
from rs_sfm_tpu.solver.flow_model import rotational_flow, translational_flow


class RefineResult(NamedTuple):
    v: jax.Array          # (3,)
    w: jax.Array          # (3,)
    k: jax.Array          # ()
    inv_depth: jax.Array  # (N,) refined ρ (unchanged where mask is False)
    cost: jax.Array       # () final masked SSE
    initial_cost: jax.Array


def _psum(x, axis_name: Optional[str]):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _residual_and_jac(coords, flow, alpha, alpha_k, v, w, k, rho):
    """Residual r (N,2) and Jacobian blocks for the masked LS problem.

    Returns (r, j_theta (N,2,7), j_rho (N,2)).
    Parameter order θ = [v(3), w(3), k].
    """
    x, y = coords[..., 0], coords[..., 1]
    beta = beta_factor(alpha, alpha_k, k)
    dbeta = beta_factor_dk(alpha, alpha_k, k)
    av = translational_flow(coords, v)   # (N, 2)
    bw = rotational_flow(coords, w)      # (N, 2)
    e = av * rho[..., None] + bw
    r = flow - beta[..., None] * e

    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    # ∂r/∂v = −β·ρ·A ;  A = [[1,0,−x],[0,1,−y]]
    brho = beta * rho
    jv = jnp.stack(
        [
            jnp.stack([-brho, zero, brho * x], axis=-1),
            jnp.stack([zero, -brho, brho * y], axis=-1),
        ],
        axis=-2,
    )
    # ∂r/∂w = −β·B ;  B = [[−xy, 1+x², −y], [−(1+y²), xy, x]]
    jw = jnp.stack(
        [
            jnp.stack([beta * x * y, -beta * (1.0 + x * x), beta * y], axis=-1),
            jnp.stack([beta * (1.0 + y * y), -beta * x * y, -beta * x], axis=-1),
        ],
        axis=-2,
    )
    # ∂r/∂k = −(dβ/dk)·e
    jk = -dbeta[..., None] * e  # (N, 2)
    j_theta = jnp.concatenate([jv, jw, jk[..., None]], axis=-1)  # (N, 2, 7)
    # ∂r/∂ρ = −β·A·v
    j_rho = -beta[..., None] * av  # (N, 2)
    return r, j_theta, j_rho


def refine(
    coords,
    flow,
    alpha,
    alpha_k,
    mask,
    v0,
    w0,
    k0,
    rho0,
    *,
    optimize_k: bool,
    iterations: int = 50,
    init_lambda: float = 1e-6,
    rel_tol: float = 1e-8,
    axis_name: Optional[str] = None,
    loss_delta: float = 0.0,
) -> RefineResult:
    """Schur-reduced LM refinement (reference nonLinearRefinement,
    src/nonlinearRefinement.cc:183-252).

    loss_delta > 0 switches the objective to the Huber loss on the
    per-pixel residual norm (IRLS weights w = min(1, δ/‖r‖) folded into
    the masked sums; the per-pixel VarPro depth is weight-invariant).
    The reference's Ceres loss hooks exist but are nullptr (plain L2,
    src/nonlinearRefinement.cc:131-134) — 0.0 reproduces that.

    Args:
      coords, flow: (N, 2) normalized coordinates / γ-scaled flow.
      alpha, alpha_k: (N,) RS factors.
      mask: (N,) bool — pixels participating (the RANSAC inlier set; the
        reference builds its problem over inliers only).
      v0, w0, k0, rho0: initialization (RANSAC output; rho0 = ρ per pixel).
      optimize_k: include k as a free parameter (constant-acceleration mode;
        src/nonlinearRefinement.cc:221-223 freezes k otherwise).
      iterations: max LM iterations (Ceres default max is 50).
      rel_tol: stop after an accepted step whose relative cost decrease is
        below this (Ceres' function_tolerance analog); 0 disables.
      axis_name: mesh axis for psum when pixels are sharded (shard_map).

    Returns:
      RefineResult.  Depths outside the mask pass through unchanged.
    """
    dt = coords.dtype
    m = mask.astype(dt)
    delta = jnp.asarray(loss_delta, dt)
    robust = loss_delta > 0.0

    def _rho_loss(sq):
        """Residual-norm loss: ‖r‖² (L2) or Huber(‖r‖)."""
        if not robust:
            return sq
        nrm = jnp.sqrt(sq + 1e-24)
        return jnp.where(nrm <= delta, sq, 2.0 * delta * nrm - delta * delta)

    def _irls_w(sq):
        """Lagged IRLS weight w = ρ'(‖r‖)/‖r‖ (1 inside the Huber knee)."""
        if not robust:
            return jnp.ones_like(sq)
        nrm = jnp.sqrt(sq + 1e-24)
        return jnp.minimum(jnp.ones_like(nrm), delta / nrm)

    def cost_fn(v, w, k, rho):
        beta = beta_factor(alpha, alpha_k, k)
        e = translational_flow(coords, v) * rho[..., None] + rotational_flow(coords, w)
        r = flow - beta[..., None] * e
        return _psum(jnp.sum(m * _rho_loss(jnp.sum(r * r, axis=-1))),
                     axis_name)

    k_keep = jnp.asarray(1.0 if optimize_k else 0.0, dt)

    def step(state):
        i, v, w, k, rho, lam, cost, done = state
        r, j_theta, j_rho = _residual_and_jac(
            coords, flow, alpha, alpha_k, v, w, k, rho)
        # Freeze k by zeroing its Jacobian column (δk solves to 0 below).
        j_theta = j_theta.at[..., 6].multiply(k_keep)

        # Robust loss: fold the lagged IRLS weight into the pixel mask
        # (GN on the weighted LS majorizer; Triggs-style second-order
        # corrections are unnecessary at the Huber knee).  The x_aug Gram
        # squares its row scaling, so it takes √(m·w) (m is 0/1); the
        # single-factor sums take m·w directly.
        m_eff = m * _irls_w(jnp.sum(r * r, axis=-1))
        mw = jnp.sqrt(m_eff)[..., None]
        # One augmented Gram product gives JᵀJ, Jᵀr and rᵀr together:
        # X = [Jθ | r] masked, M = XᵀX ⇒ H = M[:7,:7], g = M[:7,7],
        # current cost = M[7,7].
        x_aug = jnp.concatenate(
            [j_theta * mw[..., None], (r * mw)[..., None]], axis=-1)
        # The 7x7 Schur assembly is cancellation-sensitive: the sums are
        # exact-product reductions (linalg.gram), never TF32 matmuls.
        gram = linalg.gram(x_aug)
        h_tt = _psum(gram[:7, :7], axis_name)
        g_t = _psum(gram[:7, 7], axis_name)
        c_i = jnp.sum(j_theta * (j_rho * m_eff[..., None])[..., None],
                      axis=-2)                               # (N, 7)
        d_i = jnp.sum(j_rho * j_rho, axis=-1) * m_eff        # (N,)
        g_rho = jnp.sum(j_rho * r, axis=-1) * m_eff          # (N,)

        # LM damping on the diagonals (multiplicative, Marquardt-style).
        diag = jnp.diagonal(h_tt)
        h_aug = h_tt + jnp.diag(lam * (diag + 1e-12))
        # Keep the frozen-k row/column invertible.
        h_aug = h_aug.at[6, 6].add(1.0 - k_keep)
        d_aug = d_i * (1.0 + lam)
        d_safe = jnp.where(d_aug > 0.0, d_aug, jnp.ones_like(d_aug))
        informative = (d_aug > 0.0)

        # Augmented Schur product: Y = [c/√d̃ | g_ρ/√d̃] ⇒ YᵀY packs
        # Σ c cᵀ/d̃ and Σ c g_ρ/d̃ into one Gram matrix.
        inv_sqrt_d = jnp.where(informative, 1.0 / jnp.sqrt(d_safe), 0.0)
        y_aug = jnp.concatenate(
            [c_i * inv_sqrt_d[..., None],
             (g_rho * inv_sqrt_d)[..., None]], axis=-1)
        gram_y = _psum(linalg.gram(y_aug), axis_name)
        h_red = h_aug - gram_y[:7, :7]
        g_red = g_t - gram_y[:7, 7]

        # GN step: (JᵀJ)δ = −Jᵀr  (note r = observed − predicted, and
        # j_theta = ∂r/∂θ, so the normal equations carry the minus here).
        # Jacobi preconditioning: the diagonal spans ~4 orders of magnitude
        # (w ~1e5, v ~1e2, k ~1e1 on 600px problems); the symmetrized
        # D⁻½·H·D⁻½ solve keeps the small-curvature k direction in f32.
        d_pre = jnp.diagonal(h_red)
        d_pre = jnp.where(d_pre > 0.0, d_pre, jnp.ones_like(d_pre))
        s_pre = 1.0 / jnp.sqrt(d_pre)
        h_pre = h_red * s_pre[:, None] * s_pre[None, :]
        delta_theta = s_pre * linalg.gauss_solve(h_pre, -g_red * s_pre)

        v_new = v + delta_theta[:3]
        w_new = w + delta_theta[3:6]
        k_new = k + delta_theta[6]
        # Variable projection: ρ is re-ELIMINATED exactly (closed-form
        # per-pixel optimum at the candidate motion, solver/depth.py) rather
        # than GN-updated.  The GN ρ-update makes the joint iteration crawl
        # along the k/(v,w,ρ) trade-off valley (measured: ~0.005 per
        # iteration, 200 iterations from k=0 to k̂=0.47); VarPro reaches the
        # same optimum in ~10.  Masked-out pixels keep their incoming ρ
        # (pass-through contract).
        rho_star, informative = estimate_inverse_depth_info(
            coords, flow, v_new, w_new, k_new, alpha, alpha_k)
        # Uninformative pixels (vanishing translational flow) keep their
        # incoming ρ — matches the reference's Ceres (which leaves its ρ
        # init untouched there);
        # cost-neutral either way.
        rho_new = jnp.where(mask & informative, rho_star, rho)

        new_cost = cost_fn(v_new, w_new, k_new, rho_new)
        accept = (new_cost < cost) & jnp.isfinite(new_cost)
        converged = accept & (cost - new_cost <= rel_tol * cost)
        v = jnp.where(accept, v_new, v)
        w = jnp.where(accept, w_new, w)
        k = jnp.where(accept, k_new, k)
        rho = jnp.where(accept, rho_new, rho)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12), lam * 4.0)
        return i + 1, v, w, k, rho, lam, cost, done | converged

    def cond(state):
        i = state[0]
        done = state[-1]
        return (i < iterations) & ~done

    v0 = jnp.asarray(v0, dt)
    w0 = jnp.asarray(w0, dt)
    k0 = jnp.asarray(k0, dt)
    rho0 = jnp.asarray(rho0, dt)
    lam0 = jnp.asarray(init_lambda, dt)
    cost0 = cost_fn(v0, w0, k0, rho0)
    init = (jnp.int32(0), v0, w0, k0, rho0, lam0, cost0, jnp.bool_(False))
    if rel_tol == 0.0:
        # Static trip count (no early stop): fori_loop compiles leaner.
        _, v, w, k, rho, _, cost, _ = jax.lax.fori_loop(
            0, iterations, lambda _, s: step(s), init)
    else:
        _, v, w, k, rho, _, cost, _ = jax.lax.while_loop(cond, step, init)
    return RefineResult(v=v, w=w, k=k, inv_depth=rho, cost=cost,
                        initial_cost=cost0)
