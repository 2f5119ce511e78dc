"""Ground-truth flow from unprojection maps and per-scanline poses.

Replaces Camera::calculateTrueFlow (reference src/camera.cc:209-249) +
RsFrame::calculateImageCoordinatesRsFrame (src/rsframe.cc:740-768): for every
pixel of frame 1, take its ground-truth world point, project it into frame 2
under *every* scanline pose, and keep the scanline whose projected y best
matches its own index (the implicit RS projection).  The reference does this
as an O(H) loop per pixel (HOT LOOP A, ~O(H²W) scalar projections); here it
is a lax.scan over scanlines with all pixels projected at once — the same
FLOPs as one batched matmul sweep, no per-pixel branching.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rs_sfm_tpu.geom.camera import Intrinsics, pixel_grid, space_to_plane

# Per-pixel geometry: a default-precision f32 product may run in TF32 on
# a GPU, ~1e-3 relative, i.e. pixels at f ≈ 1800.
_HI = jax.lax.Precision.HIGHEST


def true_flow(unproj1, poses2_r, poses2_t, intr: Intrinsics,
              use_fy: bool = True, subscanline: bool = True):
    """Exact RS→RS flow field, in pixels.

    Args:
      unproj1: (H, W, 3) frame-1 unprojection map (world coords; 0-norm rows
        mark void pixels).
      poses2_r: (H, 3, 3) frame-2 per-scanline world→camera rotations.
      poses2_t: (H, 3) frame-2 per-scanline translations.
      intr: pinhole intrinsics.
      use_fy: False reproduces the reference's f_x-for-y projection quirk
        (src/rsframe.cc:639).
      subscanline: interpolate the RS observation between the two scanlines
        bracketing the crossing y_proj(i) = i (solving the implicit RS
        projection to first order in the scanline interval).  The
        reference keeps the discrete best scanline (src/camera.cc:222-230),
        which quantizes the implied observation time to ±half a scanline —
        a γ/(2H)-relative flow error that dominates the GT-flow accuracy
        floor of the figure-4/5 protocol.  False reproduces the reference.

    Returns:
      (H, W, 2) pixel flow.  Void pixels (zero world norm) get zero flow,
      as do pixels whose best projection lands exactly at (0,0) — both
      reference behaviors (src/camera.cc:231-240).
    """
    h, w_cols = unproj1.shape[:2]
    dtype = unproj1.dtype
    grid = pixel_grid(h, w_cols, dtype=dtype)

    def project(r_i, t_i):
        cam = jnp.einsum("ij,hwj->hwi", r_i, unproj1,
                         precision=_HI) + t_i  # (H, W, 3)
        return space_to_plane(cam, intr, use_fy=use_fy)      # (H, W, 2)

    def body(carry, pose):
        best_diff, best_pt, best_g, best_row = carry
        r_i, t_i, row = pose
        pt = project(r_i, t_i)
        g = pt[..., 1] - row          # signed crossing residual
        diff = jnp.abs(g)
        diff = jnp.where(jnp.isfinite(diff), diff, jnp.inf)
        closer = diff < best_diff
        best_pt = jnp.where(closer[..., None], pt, best_pt)
        best_g = jnp.where(closer, g, best_g)
        best_diff = jnp.where(closer, diff, best_diff)
        best_row = jnp.where(closer, row, best_row)
        return (best_diff, best_pt, best_g, best_row), None

    # First pass: find the best (discrete) scanline per pixel.
    rows = jnp.arange(h, dtype=dtype)
    init = (jnp.full((h, w_cols), jnp.inf, dtype=dtype),
            jnp.zeros((h, w_cols, 2), dtype=dtype),
            jnp.zeros((h, w_cols), dtype=dtype),
            jnp.full((h, w_cols), -1.0, dtype=dtype))
    (best_diff, best_pt, best_g, best_row), _ = jax.lax.scan(
        body, init, (poses2_r, poses2_t, rows))

    if subscanline:
        # Second pass: gather the neighbor scanline on the crossing side and
        # interpolate pt linearly in scanline time.  g(i) = y_proj(i) − i is
        # locally affine in i; the crossing sits at i* + τ with
        # τ = g(i*) / (g(i*) − g(i_nb)) on the side sign(g) points to.
        side = jnp.where(best_g > 0.0, 1.0, -1.0)
        nb_row = jnp.clip(best_row + side, 0.0, h - 1.0)
        nb_idx = nb_row.astype(jnp.int32)

        def nb_body(carry, pose):
            nb_pt, nb_g = carry
            r_i, t_i, row = pose
            pt = project(r_i, t_i)
            g = pt[..., 1] - row
            hit = nb_idx == jnp.asarray(row, jnp.int32)
            nb_pt = jnp.where(hit[..., None], pt, nb_pt)
            nb_g = jnp.where(hit, g, nb_g)
            return (nb_pt, nb_g), None

        (nb_pt, nb_g), _ = jax.lax.scan(
            nb_body,
            (jnp.zeros((h, w_cols, 2), dtype=dtype),
             jnp.zeros((h, w_cols), dtype=dtype)),
            (poses2_r, poses2_t, rows))
        denom = best_g - nb_g
        tau = jnp.where(jnp.abs(denom) > 1e-12, best_g / denom, 0.0)
        # Only interpolate when the neighbor actually brackets the crossing
        # (g signs differ) and exists (row not clipped onto itself).
        ok = (jnp.sign(nb_g) != jnp.sign(best_g)) & (nb_row != best_row) \
            & jnp.isfinite(nb_g) & jnp.isfinite(best_g)
        tau = jnp.where(ok, jnp.clip(tau, 0.0, 1.0), 0.0)
        best_pt = best_pt + tau[..., None] * (nb_pt - best_pt)

    flow = best_pt - grid
    void = jnp.linalg.norm(unproj1, axis=-1) == 0.0
    # Reference quirk: a projected point at exactly (0, 0) also maps to zero
    # flow (src/camera.cc:235-237).
    degenerate = jnp.linalg.norm(best_pt, axis=-1) == 0.0
    no_hit = ~jnp.isfinite(best_diff)
    zero = void | degenerate | no_hit
    return jnp.where(zero[..., None], jnp.zeros_like(flow), flow)
