"""Z-buffered back-projection scatter: RS image + depth + scanline poses →
rectified GS image + 3D point cloud.

Reference behavior (src/rsframe.cc:803-839): per pixel, unproject through the
depth map under its scanline pose to world, reproject under the scanline-0
pose, round, and write the RS color into the GS image — last-writer-wins in
row-major scan order, a nondeterministic choice under any parallel order.
Here conflicts resolve by *minimum depth* (front surface wins), which is
deterministic under any sharding.  Void pixels (RGB(1,1,1) mask — exact
match on the uint8 value 1 — src/rsframe.cc:815) and zero-depth pixels are
skipped.

Conflict-resolution engines:
  * "packed24" (default): ONE scatter-min on a (quantized depth | 24-bit
    color) int32 key — the winning COLOR rides in the key, so there is no
    source-id gather at all.  Depth is quantized to
    7 bits (128 levels over the scene span; the front/back separation this
    stage needs), colors to 8 bits/channel (exact for uint8 sources, the
    reference's image type — src/rsframe.cc:803); ties at equal quantized
    depth break toward the smallest packed color (deterministic).
  * "packed": scatter-min on (9-bit depth | source id) + one color
    gather — exact colors for float sources, ties by lowest id.
  * "scatter": two-pass scatter-min on exact float depths — the
    bit-exact-depth reference implementation.
  * "sort": scatter-free stable-sort + binary search; useful on backends
    where scatter is the slow path.
The scatter-min engines are deterministic on a GPU although the updates
land through atomics in no fixed order: min commutes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rs_sfm_tpu.geom.camera import (Intrinsics, pixel_grid, plane_to_space,
                                    space_to_plane)
from rs_sfm_tpu.geom.rspose import camera_to_world, world_to_camera


class BackprojectResult(NamedTuple):
    gs_image: jax.Array    # (H, W, 3) rectified global-shutter image
    coords_3d: jax.Array   # (H, W, 3) world coords per *source* RS pixel
    valid: jax.Array       # (H, W) bool — source pixels that back-projected
    scattered: jax.Array   # (H, W) bool — target pixels that received a color


def _is_void_color(image):
    """The reference's mask: color exactly RGB(1,1,1) in uint8
    (src/rsframe.cc:815).  Works for both uint8 and unit-float images."""
    if jnp.issubdtype(image.dtype, jnp.floating):
        return jnp.all(jnp.abs(image * 255.0 - 1.0) < 0.5, axis=-1)
    return jnp.all(image == 1, axis=-1)


def _resolve_sort(flat_idx, src_depth, colors, n, depth_bits: int = 9):
    """Scatter-free min-depth conflict resolution.

    Args:
      flat_idx: (n,) int32 target index per source pixel (n = dropped).
      src_depth: (n,) float target-camera depth (inf = dropped).
      colors: (n, 3) source colors.
      n: number of pixels (fits int31 with depth_bits: n·2^bits < 2^31).

    Returns:
      (gs_flat (n, 3), scattered_flat (n,)).
    """
    levels = 1 << depth_bits
    finite = jnp.isfinite(src_depth)
    d = jnp.where(finite, src_depth, 0.0)
    dmin = jnp.min(jnp.where(finite, d, jnp.inf))
    dmax = jnp.max(jnp.where(finite, d, -jnp.inf))
    span = jnp.maximum(dmax - dmin, 1e-12)
    qd = jnp.clip(((d - dmin) / span * (levels - 1)).astype(jnp.int32),
                  0, levels - 1)
    key = jnp.where(finite & (flat_idx < n),
                    flat_idx * levels + qd,
                    jnp.asarray(n * levels, jnp.int32))
    src_ids = jnp.arange(n, dtype=jnp.int32)
    sorted_key, sorted_src = jax.lax.sort((key, src_ids), num_keys=1,
                                          is_stable=True)
    targets = src_ids * levels
    pos = jnp.searchsorted(sorted_key, targets, side="left")
    pos_c = jnp.minimum(pos, n - 1)
    k_at = sorted_key[pos_c]
    hit = (k_at // levels) == src_ids
    winner = sorted_src[pos_c]
    gs_flat = jnp.where(hit[:, None], colors[winner], jnp.zeros_like(colors))
    return gs_flat, hit


@jax.named_scope("rectify")
def backproject(image, depth_map, poses_r, poses_t, intr: Intrinsics,
                *, use_fy: bool = True, use_scanline_pose: bool = True,
                method: str = "packed24") -> BackprojectResult:
    """Rectify an RS image given per-pixel depth and per-scanline poses.

    Args:
      image: (H, W, 3) RS image (uint8 or float in [0,1]).
      depth_map: (H, W) per-pixel depth (0 = unknown, skipped).
      poses_r, poses_t: (H, 3, 3)/(H, 3) relative scanline poses
        (world→camera; scanline 0 is the reprojection target).
      intr: intrinsics.
      use_fy: False reproduces the reference's f_x-for-y quirk.
      use_scanline_pose: False gives the GS-assumption baseline
        (backProjectGs, src/rsframe.cc:842-878): unproject under the
        scanline-0 pose as well.

    Returns:
      BackprojectResult.
    """
    h, w_cols = depth_map.shape
    dtype = depth_map.dtype
    grid = pixel_grid(h, w_cols, dtype=dtype)

    valid = (depth_map != 0.0) & ~_is_void_color(image)

    cam = plane_to_space(grid, depth_map, intr)  # (H, W, 3)
    if use_scanline_pose:
        r_rows = poses_r[:, None, :, :]
        t_rows = poses_t[:, None, :]
    else:
        r_rows = poses_r[0][None, None]
        t_rows = poses_t[0][None, None]
    world = camera_to_world(cam, r_rows, t_rows)  # (H, W, 3)
    cam0 = world_to_camera(world, poses_r[0], poses_t[0])
    pt = space_to_plane(cam0, intr, use_fy=use_fy)  # (H, W, 2)

    # Rounding as in the reference: int(x + 0.5) (src/rsframe.cc:831).
    px = jnp.floor(pt[..., 0] + 0.5).astype(jnp.int32)
    py = jnp.floor(pt[..., 1] + 0.5).astype(jnp.int32)
    in_bounds = (px >= 0) & (px < w_cols) & (py >= 0) & (py < h)
    write = valid & in_bounds & jnp.isfinite(pt).all(axis=-1)

    n = h * w_cols
    flat_idx = jnp.where(write, py * w_cols + px, n).reshape(-1)  # n = drop slot
    src_depth = jnp.where(write, cam0[..., 2], jnp.inf).reshape(-1)
    colors = image.reshape(n, 3)

    if method == "packed24":
        # Gather-free: the color rides inside the scatter-min key.
        # key = qd(7 bits) << 24 | r << 16 | g << 8 | b, clamped to
        # 0x7FFFFFFE so no live key collides with the 0x7FFFFFFF sentinel.
        if jnp.issubdtype(image.dtype, jnp.floating):
            c8 = jnp.clip(jnp.round(colors * 255.0), 0, 255).astype(
                jnp.int32)
        else:
            c8 = colors.astype(jnp.int32)
        color24 = (c8[:, 0] << 16) | (c8[:, 1] << 8) | c8[:, 2]
        levels = 1 << 7
        finite = jnp.isfinite(src_depth)
        dvals = jnp.where(finite, src_depth, 0.0)
        dmin = jnp.min(jnp.where(finite, dvals, jnp.inf))
        dmax = jnp.max(jnp.where(finite, dvals, -jnp.inf))
        span = jnp.maximum(dmax - dmin, 1e-12)
        qd = jnp.clip(((dvals - dmin) / span * (levels - 1)).astype(
            jnp.int32), 0, levels - 1)
        sentinel = jnp.int32(2 ** 31 - 1)
        # qd=127 with pure-white color packs to exactly 0x7FFFFFFF == the
        # sentinel, which would mark the pixel unscattered; clamp to
        # sentinel-1 (perturbs only the blue LSB of that one combo).
        packed = jnp.where(finite & (flat_idx < n),
                           jnp.minimum((qd << 24) | color24, sentinel - 1),
                           sentinel)
        buf = jnp.full((n + 1,), sentinel, dtype=jnp.int32)
        buf = buf.at[flat_idx].min(packed)[:n]
        hit = buf != sentinel
        win24 = jnp.where(hit, buf & 0xFFFFFF, 0)
        c_out = jnp.stack([(win24 >> 16) & 0xFF, (win24 >> 8) & 0xFF,
                           win24 & 0xFF], axis=-1)
        if jnp.issubdtype(image.dtype, jnp.floating):
            gs_image = (c_out.astype(image.dtype) / 255.0).reshape(
                h, w_cols, 3)
        else:
            gs_image = c_out.astype(image.dtype).reshape(h, w_cols, 3)
        scattered = hit.reshape(h, w_cols)
    elif method == "packed":
        # One scatter-min on a packed (quantized depth | source id) int32 key
        # + one gather: the winner per target pixel falls out of a single
        # atomic-free min, ties broken by lowest source id.
        src_bits = (n - 1).bit_length()
        depth_bits = 30 - src_bits
        if depth_bits < 4:
            raise ValueError(f"image too large for packed z-buffer: {n}")
        levels = 1 << depth_bits
        finite = jnp.isfinite(src_depth)
        dvals = jnp.where(finite, src_depth, 0.0)
        dmin = jnp.min(jnp.where(finite, dvals, jnp.inf))
        dmax = jnp.max(jnp.where(finite, dvals, -jnp.inf))
        span = jnp.maximum(dmax - dmin, 1e-12)
        qd = jnp.clip(((dvals - dmin) / span * (levels - 1)).astype(jnp.int32),
                      0, levels - 1)
        sentinel = jnp.int32(2 ** 31 - 1)
        src_ids = jnp.arange(n, dtype=jnp.int32)
        packed = jnp.where(finite & (flat_idx < n),
                           qd * (1 << src_bits) + src_ids, sentinel)
        buf = jnp.full((n + 1,), sentinel, dtype=jnp.int32)
        buf = buf.at[flat_idx].min(packed)[:n]
        hit = buf != sentinel
        winner = jnp.where(hit, buf & ((1 << src_bits) - 1), 0)
        gs_image = jnp.where(hit[:, None], colors[winner],
                             jnp.zeros_like(colors)).reshape(h, w_cols, 3)
        scattered = hit.reshape(h, w_cols)
    elif method == "sort":
        gs_flat, hit = _resolve_sort(flat_idx.astype(jnp.int32),
                                     src_depth.astype(jnp.float32), colors, n)
        gs_image = gs_flat.reshape(h, w_cols, 3)
        scattered = hit.reshape(h, w_cols)
    elif method == "scatter":
        # Pass 1: winning (minimum) target depth.
        zbuf = jnp.full((n + 1,), jnp.inf, dtype=dtype)
        zbuf = zbuf.at[flat_idx].min(src_depth)
        # Pass 2: among depth winners, lowest source index wins (total order).
        is_winner = src_depth == zbuf[flat_idx]
        src_ids = jnp.arange(n, dtype=jnp.int32)
        winner_id = jnp.full((n + 1,), n, dtype=jnp.int32)
        winner_id = winner_id.at[flat_idx].min(
            jnp.where(is_winner, src_ids, n))
        final = (winner_id[flat_idx] == src_ids) & (flat_idx < n)

        gs_flat = jnp.zeros((n + 1, 3), dtype=image.dtype)
        gs_flat = gs_flat.at[jnp.where(final, flat_idx, n)].set(colors)
        gs_image = gs_flat[:n].reshape(h, w_cols, 3)

        scattered_flat = jnp.zeros((n + 1,), dtype=bool)
        scattered_flat = scattered_flat.at[
            jnp.where(final, flat_idx, n)].set(True)
        scattered = scattered_flat[:n].reshape(h, w_cols)
    else:
        raise ValueError(f"unknown method {method!r}")

    coords_3d = jnp.where(valid[..., None], world, jnp.zeros_like(world))
    return BackprojectResult(gs_image=gs_image, coords_3d=coords_3d,
                             valid=valid, scattered=scattered)
