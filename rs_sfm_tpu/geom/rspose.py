"""Rolling-shutter per-scanline pose model.

Replaces RsFrame's pose machinery (reference src/rsframe.cc:687-800,
953-967).  A frame's scanline poses are dense arrays R: (H, 3, 3),
t: (H, 3) in the world->camera convention X_cam = R X_world + t (the
convention of the reference's worldToCameraFrame, src/rsframe.cc:687-708,
and of the synthetic dataset CSVs).

The motion model (report eq. 15-16): scanline i of the frame, read at
normalized time γ·i/H after scanline 0, has relative pose
    t_i = β₁(i)·v,        R_i = I + β₁(i)·ŵ,
    β₁(i) = (2/(2+k)) · (γ·i/H + ½·k·(γ·i/H)²)
(reference src/rsframe.cc:771-800; MATLAB generator
calculate_camera_trajectory.m:17-18 uses the same β with the second frame's
scanlines at normalized times 1 + γ·i/H via β₂).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rs_sfm_tpu.geom import so3

# Per-pixel geometry: a default-precision f32 product may run in TF32 on
# a GPU, ~1e-3 relative, i.e. pixels at f ≈ 1800.
_HI = jax.lax.Precision.HIGHEST


def beta1(row, rows, gamma, k):
    """β₁ for scanline(s) `row` of the first frame (times γ·row/H).

    Matches src/rsframe.cc:790.  `row` may be an array.
    """
    tau = gamma * row / rows
    return (2.0 / (2.0 + k)) * (tau + 0.5 * k * tau * tau)


def beta2(row, rows, gamma, k):
    """β analog for scanline(s) of the *second* frame (times 1 + γ·row/H).

    Matches the MATLAB generator (calculate_camera_trajectory.m:18).
    """
    tau = 1.0 + gamma * row / rows
    return (2.0 / (2.0 + k)) * (tau + 0.5 * k * tau * tau)


def scanline_poses(v, w, k, rows, gamma, dtype=None):
    """All relative scanline poses of a frame from (v, w, k).

    Vectorized equivalent of RsFrame::setRelativePose
    (src/rsframe.cc:771-800): scanline 0 is the identity; scanline i has
    t = β₁(i)·v and R = I + β₁(i)·ŵ.

    Returns:
      R: (rows, 3, 3), t: (rows, 3).
    """
    if dtype is None:
        dtype = jnp.result_type(v)
    idx = jnp.arange(rows, dtype=dtype)
    b = beta1(idx, rows, gamma, k)  # (rows,)
    r = so3.exp_first_order(jnp.broadcast_to(w, (rows, 3)).astype(dtype), scale=b)
    t = b[:, None] * jnp.asarray(v, dtype=dtype)[None, :]
    return r, t


def world_to_camera(points, r, t):
    """X_cam = R X_world + t; broadcasts (..., 3) with (..., 3, 3)/(..., 3)."""
    return jnp.einsum("...ij,...j->...i", r, points, precision=_HI) + t


def camera_to_world(points, r, t):
    """X_world = Rᵀ (X_cam - t) (reference cameraToWorldFrame,
    src/rsframe.cc:712-736)."""
    return jnp.einsum("...ji,...j->...i", r, points - t, precision=_HI)


def relocate_poses(r, t, skip_first_row: bool = False):
    """Rebase absolute scanline poses so scanline 0 sits at the origin.

    Equivalent of RsFrame::relocatePose (src/rsframe.cc:953-967):
    t_i <- t_i - t_0 and R_i <- R_0⁻¹ R_i.  The reference's loop starts at
    i = 1, leaving scanline 0 at its absolute pose — pass
    skip_first_row=True to replicate that quirk; the default rebases every
    row (scanline 0 becomes exactly the identity translation/rotation).

    Note the reference subtracts translations directly (not a group inverse
    composition); this function matches that observable behavior.
    """
    r0_inv = jnp.swapaxes(r[0], -1, -2)
    new_r = jnp.einsum("ij,njk->nik", r0_inv, r, precision=_HI)
    new_t = t - t[0]
    if skip_first_row:
        new_r = new_r.at[0].set(r[0])
        new_t = new_t.at[0].set(t[0])
    return new_r, new_t
