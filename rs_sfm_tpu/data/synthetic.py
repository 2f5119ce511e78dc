"""Procedural JAX synthetic rolling-shutter renderer.

JAX replacement for the reference's MATLAB generator
(matlab_synthetic_data/: castle.m → start_generating.m → take_sequence.m),
which renders a textured mesh once per scanline and keeps only row i.  Here
the scene is a set of textured rectangles with closed-form ray intersection,
so *every pixel of every scanline renders under its own pose in one batched
pass* — no scanline loop, no external renderer, fully jittable.

Conventions (matching the reference dataset contract):
  * Poses are world→camera: X_cam = R X_world + t (src/rsframe.cc:687-708).
  * The camera trajectory follows the constant-acceleration motion model:
    scanline i of frame 1 is at normalized time τ = γ·i/H, of frame 2 at
    τ = 1 + γ·i/H, with pose R = R₀(I + β(τ)·ŵ), t = t₀ + β(τ)·v and
    β(τ) = (2/(2+k))(τ + ½kτ²) (calculate_camera_trajectory.m:17-26).
    Divergences from the MATLAB generator, both deliberate:
      - scanline i is at time γ·i/H exactly as the estimation model assumes
        (the MATLAB script has an off-by-one: row i gets time γ·(i+1)/H
        except row 0 — take_sequence.m:10-17 with trajectory row i+1);
      - w is in radians everywhere (MATLAB stores degrees in w.csv and
        converts internally — calculate_camera_trajectory.m:6).
  * Void (sky) pixels get color RGB(1,1,1)/255 — the mask value the
    reference's backProject skips (src/rsframe.cc:815) — zero depth and
    zero unprojection coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from rs_sfm_tpu.geom import so3
from rs_sfm_tpu.geom.camera import Intrinsics
from rs_sfm_tpu.geom.rspose import beta1, beta2
from rs_sfm_tpu.ops import linalg

# Per-pixel geometry: a default-precision f32 product may run in TF32 on
# a GPU, ~1e-3 relative, i.e. pixels at f ≈ 1800.
_HI = jax.lax.Precision.HIGHEST


class Scene(NamedTuple):
    """Textured rectangles: X(a, b) = origin + a·edge1 + b·edge2, a,b ∈ [0,1].

    velocity (optional): per-rectangle world velocity (units per frame
    interval) for INDEPENDENTLY MOVING objects — the rigid-scene assumption
    breaker used by the stress scenes (the reference's dominant real-world
    failure mode, examples/README.md:14).  None/zeros = static scene.
    """

    origins: jax.Array  # (P, 3)
    edge1: jax.Array    # (P, 3)
    edge2: jax.Array    # (P, 3)
    base_color: jax.Array  # (P, 3) in [0, 1]
    velocity: jax.Array = None  # (P, 3) or None (static)
    # Optional per-prim PERIODIC texture period (texture-coordinate units;
    # 0 = the default non-repeating noise texture).  Periodic texture is
    # the classic aperture/adversarial case for discrete matching — used
    # by the repetitive-texture flow probe (VERDICT r4 #8).
    periodic: jax.Array = None  # (P,) or None


class SyntheticFrame(NamedTuple):
    rs_image: jax.Array     # (H, W, 3) float32 in [0, 1]
    gs_image: jax.Array     # (H, W, 3) rendered at this frame's scanline-0 pose
    rs_depth: jax.Array     # (H, W) camera z of each RS pixel (0 = void)
    gs_depth: jax.Array     # (H, W)
    rs_unproject: jax.Array  # (H, W, 3) world coords (0 = void)
    gs_unproject: jax.Array  # (H, W, 3)
    poses_r: jax.Array      # (H, 3, 3) world→camera per scanline (GT)
    poses_t: jax.Array      # (H, 3)
    mover_mask: jax.Array = None  # (H, W) bool — RS pixel hit a moving prim


class SyntheticPair(NamedTuple):
    frame1: SyntheticFrame
    frame2: SyntheticFrame
    intrinsics: Intrinsics
    gamma: float
    k: float
    v: jax.Array  # (3,) world units per frame interval
    w: jax.Array  # (3,) radians per frame interval


def castle_scene(dtype=jnp.float32) -> Scene:
    """Default scene: a castle-like arrangement of facades, ground and tower.

    World frame = frame-1 scanline-0 camera frame (x right, y down, z
    forward); mean depth ≈ 6, like the reference's landesmuseum renders.
    """

    def rect(p0, e1, e2, color):
        return p0, e1, e2, color

    rects = [
        # ground plane (y = +2, below the camera, stretching away)
        rect([-8.0, 2.0, 0.5], [16.0, 0.0, 0.0], [0.0, 0.0, 14.0],
             [0.45, 0.40, 0.30]),
        # back wall
        rect([-8.0, -5.0, 11.0], [16.0, 0.0, 0.0], [0.0, 7.0, 0.0],
             [0.55, 0.50, 0.45]),
        # left building face
        rect([-4.5, -3.0, 6.0], [3.2, 0.0, 0.0], [0.0, 5.0, 0.0],
             [0.60, 0.45, 0.35]),
        # right building face
        rect([0.8, -2.0, 7.5], [3.5, 0.0, 0.0], [0.0, 4.0, 0.0],
             [0.40, 0.50, 0.60]),
        # central tower
        rect([-0.7, -2.5, 4.5], [1.1, 0.0, 0.0], [0.0, 4.5, 0.0],
             [0.55, 0.55, 0.40]),
        # slanted roof piece connecting tower to right building
        rect([0.4, -2.2, 4.8], [1.6, -0.4, 1.6], [0.0, 1.2, 0.4],
             [0.62, 0.38, 0.30]),
    ]
    return Scene(
        origins=jnp.asarray([r[0] for r in rects], dtype=dtype),
        edge1=jnp.asarray([r[1] for r in rects], dtype=dtype),
        edge2=jnp.asarray([r[2] for r in rects], dtype=dtype),
        base_color=jnp.asarray([r[3] for r in rects], dtype=dtype),
    )


def repetitive_scene(dtype=jnp.float32, *, period: float = 0.045) -> Scene:
    """Adversarial probe scene (VERDICT r4 #8): castle geometry whose
    large wall surfaces carry STRICTLY PERIODIC texture.

    At the default period every wall repeat spans ~40-60 px at full-HD
    castle viewing distances — inside the coarse-level discrete search
    ambiguity, the aperture failure family of the reference's example 4.
    The ground keeps the noise texture (some unambiguous support must
    exist or the problem is unsolvable for any matcher).
    """
    base = castle_scene(dtype=dtype)
    periodic = jnp.asarray([0.0, period, period, period, period, 0.0],
                           dtype=dtype)
    return base._replace(periodic=periodic)


def castle_mesh_scene(dtype=jnp.float32, *, seed: int = 0) -> Scene:
    """Mesh-grade castle: ~120 boxes/faces with real depth discontinuities.

    The reference renders a real textured castle MESH (Hassner renderer,
    matlab_synthetic_data/README.md:3-7); the planar-dominant 10-rectangle
    `castle_scene` under-stresses depth discontinuities, sliver occlusions
    and the crack-fill/z-buffer paths (VERDICT r4 item 7).  This scene
    approaches mesh-grade geometry with the SAME exact ray-cast renderer:

      * a keep and two towers built from boxes with CRENELLATED parapets
        (0.25-0.35-unit merlons — genuine sliver occluders);
      * a staircase (step tops + risers: depth staircase discontinuities);
      * thin flag poles (0.05-unit-wide slivers spanning 1.5 units);
      * an overhanging balcony (occludes the wall below it at a depth
        gap, exercising front-surface z-buffer resolution);
      * scattered rubble boxes on the ground (random depth pockets).

    Deterministic for a given seed; every face uses the default
    non-repeating noise texture.
    """
    rng = np.random.default_rng(seed)
    rects = []

    def rect(p0, e1, e2, color):
        rects.append((np.asarray(p0, np.float64),
                      np.asarray(e1, np.float64),
                      np.asarray(e2, np.float64),
                      np.asarray(color, np.float64)))

    def box_front_top(x0, y_top, z0, wx, hy, dz, color):
        """Front face + top face + left side of an axis-aligned box
        standing on nothing in particular (y down: y_top < y_bottom)."""
        rect([x0, y_top, z0], [wx, 0.0, 0.0], [0.0, hy, 0.0], color)
        rect([x0, y_top, z0], [wx, 0.0, 0.0], [0.0, 0.0, dz], color)
        rect([x0, y_top, z0], [0.0, 0.0, dz], [0.0, hy, 0.0], color)

    # Ground + back wall (the stage).
    rect([-8.0, 2.0, 0.5], [16.0, 0.0, 0.0], [0.0, 0.0, 14.0],
         [0.45, 0.40, 0.30])
    rect([-8.0, -5.0, 11.5], [16.0, 0.0, 0.0], [0.0, 7.0, 0.0],
         [0.50, 0.47, 0.44])

    # Central keep (front at z=7) with crenellated parapet.
    rect([-2.0, -2.6, 7.0], [4.0, 0.0, 0.0], [0.0, 4.6, 0.0],
         [0.58, 0.52, 0.42])
    rect([-2.0, -2.6, 7.0], [4.0, 0.0, 0.0], [0.0, 0.0, 1.6],
         [0.52, 0.47, 0.38])
    for i in range(7):
        x = -2.0 + 0.1 + i * 0.56
        box_front_top(x, -3.05, 6.95, 0.28, 0.45, 0.35,
                      [0.56, 0.50, 0.40])

    # Balcony overhang on the keep (underside + front lip -> depth gap
    # over the wall below).
    rect([-1.2, -1.1, 6.45], [2.4, 0.0, 0.0], [0.0, 0.0, 0.55],
         [0.48, 0.42, 0.34])
    rect([-1.2, -1.1, 6.45], [2.4, 0.0, 0.0], [0.0, 0.35, 0.0],
         [0.50, 0.44, 0.36])

    # Two towers with parapets.
    for tx, tz, tw in ((-4.6, 5.6, 1.5), (3.1, 6.2, 1.4)):
        rect([tx, -3.4, tz], [tw, 0.0, 0.0], [0.0, 5.4, 0.0],
             [0.60, 0.46, 0.36])
        rect([tx, -3.4, tz], [tw, 0.0, 0.0], [0.0, 0.0, 1.2],
             [0.55, 0.42, 0.33])
        rect([tx + tw, -3.4, tz], [0.0, 0.0, 1.2], [0.0, 5.4, 0.0],
             [0.57, 0.44, 0.34])
        for i in range(4):
            x = tx + 0.05 + i * (tw - 0.3) / 3.0
            box_front_top(x, -3.82, tz - 0.05, 0.22, 0.42, 0.3,
                          [0.58, 0.44, 0.35])

    # Staircase up to the keep (8 steps).
    for i in range(8):
        sx, sw = 0.1, 1.3
        z = 5.8 - i * 0.28
        y = 2.0 - (i + 1) * 0.22
        rect([sx, y, z], [sw, 0.0, 0.0], [0.0, 0.0, 0.28],
             [0.47, 0.43, 0.36])                       # tread
        rect([sx, y, z], [sw, 0.0, 0.0], [0.0, 0.22, 0.0],
             [0.44, 0.40, 0.34])                       # riser

    # Flag poles (slivers) on keep + towers.
    for px, pz in ((-0.1, 6.9), (-4.2, 5.55), (3.6, 6.15)):
        rect([px, -4.9, pz], [0.05, 0.0, 0.0], [0.0, 1.6, 0.0],
             [0.30, 0.28, 0.26])
        rect([px + 0.05, -4.85, pz], [0.45, 0.0, 0.0], [0.0, 0.3, 0.0],
             [0.70, 0.25, 0.20])                       # flag

    # Rubble boxes on the ground (random sizes/depths).
    for _ in range(12):
        bx = rng.uniform(-5.5, 5.5)
        bz = rng.uniform(2.2, 9.5)
        bw = rng.uniform(0.25, 0.8)
        bh = rng.uniform(0.2, 0.6)
        bd = rng.uniform(0.25, 0.7)
        shade = rng.uniform(0.35, 0.65)
        box_front_top(bx, 2.0 - bh, bz, bw, bh, bd,
                      [shade, shade * 0.95, shade * 0.85])

    return Scene(
        origins=jnp.asarray([r[0] for r in rects], dtype=dtype),
        edge1=jnp.asarray([r[1] for r in rects], dtype=dtype),
        edge2=jnp.asarray([r[2] for r in rects], dtype=dtype),
        base_color=jnp.asarray([r[3] for r in rects], dtype=dtype),
    )


def _hash_noise(u, v, seed):
    """Value noise on a texel grid: bilinear interpolation of a
    sin-fract hash (non-repeating — periodic textures alias discrete
    matching, the classic aperture failure)."""

    def hash2(i, j):
        s = jnp.sin(i * 12.9898 + j * 78.233 + seed) * 43758.5453
        return s - jnp.floor(s)

    iu = jnp.floor(u)
    iv = jnp.floor(v)
    fu = u - iu
    fv = v - iv
    # Smoothstep weights for C1 continuity.
    fu = fu * fu * (3.0 - 2.0 * fu)
    fv = fv * fv * (3.0 - 2.0 * fv)
    h00 = hash2(iu, iv)
    h10 = hash2(iu + 1.0, iv)
    h01 = hash2(iu, iv + 1.0)
    h11 = hash2(iu + 1.0, iv + 1.0)
    return ((1 - fu) * (1 - fv) * h00 + fu * (1 - fv) * h10
            + (1 - fu) * fv * h01 + fu * fv * h11)


def _texture(prim_id, a, b, base_color):
    """Procedural texture: multi-scale value noise + soft stripes.

    Feature-rich and non-repeating (for dense-flow matching), bounded away
    from both black and the RGB(1,1,1)/255 void sentinel.
    """
    phase = prim_id.astype(a.dtype)
    n1 = _hash_noise(a * 9.0, b * 9.0, phase * 17.0) - 0.5
    n2 = _hash_noise(a * 27.0, b * 27.0, phase * 31.0 + 5.0) - 0.5
    f1 = jnp.sin(2.0 * jnp.pi * (7.0 + 2.0 * phase) * a + phase * 1.7)
    checker = jnp.sin(2.0 * jnp.pi * 3.0 * a) * jnp.sin(2.0 * jnp.pi * 3.0 * b)
    mod = 0.34 * n1 + 0.22 * n2 + 0.10 * f1 + 0.10 * checker
    col = base_color * (0.75 + mod[..., None] * jnp.asarray(
        [1.0, 0.85, 0.7], dtype=a.dtype))
    return jnp.clip(col, 0.02, 0.98)


def _texture_periodic(a, b, base_color, period):
    """Strictly periodic brick-like pattern (period in texture coords):
    soft-edged checker + grating with NO aperiodic component — every
    period-shifted displacement is a perfect photometric match."""
    pa = a / period
    pb = b / period
    sq = jnp.tanh(8.0 * jnp.sin(2.0 * jnp.pi * pa)) * jnp.tanh(
        8.0 * jnp.sin(2.0 * jnp.pi * pb))
    grat = 0.3 * jnp.sin(2.0 * jnp.pi * 2.0 * pa)
    mod = 0.30 * sq + grat
    col = base_color * (0.75 + mod[..., None] * jnp.asarray(
        [1.0, 0.9, 0.8], dtype=a.dtype))
    return jnp.clip(col, 0.02, 0.98)


def _intersect(scene: Scene, origin, direction, time=None):
    """Nearest-hit ray casting against all rectangles.

    Args:
      origin: (..., 3) ray origins (world).
      direction: (..., 3) ray directions (world; scaled so that the camera
        z equals the ray parameter t — i.e. d = Rᵀ·d_cam with d_cam.z = 1).
      time: (...,) per-ray capture time (frame intervals) — moving
        primitives (scene.velocity) are displaced by time·velocity, so each
        scanline sees the mover where it is AT ITS OWN readout instant.

    Returns:
      (depth (...,), world_point (..., 3), color (..., 3), hit (...,),
       mover (...,) bool — nearest hit was a moving primitive).
    """
    dtype = origin.dtype
    best_t = jnp.full(origin.shape[:-1], jnp.inf, dtype=dtype)
    best_color = jnp.ones(origin.shape[:-1] + (3,), dtype=dtype) / 255.0
    best_mover = jnp.zeros(origin.shape[:-1], dtype=bool)
    num_prims = scene.origins.shape[0]
    # Per-primitive static/moving decided at trace time (concrete scene
    # constants); a traced velocity conservatively treats every prim as
    # moving (correct, just loses the static fast path).
    if scene.velocity is None or time is None:
        moving_flags = [False] * num_prims
    else:
        try:
            moving_flags = list(
                (np.asarray(scene.velocity) != 0.0).any(axis=1))
        except Exception:
            moving_flags = [True] * num_prims
    for p in range(num_prims):
        p0 = scene.origins[p]
        moving = moving_flags[p]
        if moving:
            p0 = p0 + time[..., None] * scene.velocity[p]
        e1 = scene.edge1[p]
        e2 = scene.edge2[p]
        n = jnp.cross(e1, e2)
        denom = jnp.einsum("...i,i->...", direction, n, precision=_HI)
        safe = jnp.where(jnp.abs(denom) < 1e-12, jnp.ones_like(denom), denom)
        t = jnp.einsum("...i,i->...", p0 - origin, n,
                       precision=_HI) / safe
        hit_pt = origin + t[..., None] * direction
        rel = hit_pt - p0
        a = (jnp.einsum("...i,i->...", rel, e1, precision=_HI)
             / jnp.dot(e1, e1, precision=_HI))
        b = (jnp.einsum("...i,i->...", rel, e2, precision=_HI)
             / jnp.dot(e2, e2, precision=_HI))
        ok = ((jnp.abs(denom) >= 1e-12) & (t > 1e-3)
              & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0))
        closer = ok & (t < best_t)
        color = _texture(jnp.asarray(p), a, b, scene.base_color[p])
        if scene.periodic is not None:
            per = float(np.asarray(scene.periodic)[p])
            if per > 0.0:
                color = _texture_periodic(a, b, scene.base_color[p],
                                          jnp.asarray(per, dtype))
        best_color = jnp.where(closer[..., None], color, best_color)
        best_t = jnp.where(closer, t, best_t)
        best_mover = jnp.where(closer, moving, best_mover)
    hit = jnp.isfinite(best_t)
    depth = jnp.where(hit, best_t, jnp.zeros_like(best_t))
    world = jnp.where(hit[..., None], origin + best_t[..., None] * direction,
                      jnp.zeros_like(origin))
    return depth, world, best_color, hit, best_mover


def _row_poses(r0, t0, v, w, betas):
    """Poses R = R₀(I + β·ŵ), t = t₀ + β·v for a vector of β values."""
    n = betas.shape[0]
    w_b = jnp.broadcast_to(w, (n, 3))
    r = jnp.einsum("ij,njk->nik", r0, so3.exp_first_order(w_b, scale=betas),
                   precision=_HI)
    t = t0[None, :] + betas[:, None] * v[None, :]
    return r, t


def _render(scene, intr: Intrinsics, rows, cols, r_rows, t_rows, dtype,
            times=None):
    """Render an image where row y uses pose (r_rows[y], t_rows[y]).

    Passing broadcasted single poses renders a global-shutter image.
    times: optional (H,) per-scanline capture times for moving primitives.
    """
    ys, xs = jnp.meshgrid(jnp.arange(rows, dtype=dtype),
                          jnp.arange(cols, dtype=dtype), indexing="ij")
    d_cam = jnp.stack(
        [(xs - intr.cx) / intr.fx, (ys - intr.cy) / intr.fy,
         jnp.ones_like(xs)], axis=-1)  # (H, W, 3)
    # Invert the affine map X_cam = R X + t *exactly* (R = I + βŵ is only
    # first-order orthonormal, so Rᵀ would introduce O((βω)²) inconsistency
    # between the unprojection maps and the world→camera contract):
    # camera center o = −R⁻¹t, world direction d = R⁻¹ d_cam (d_cam.z = 1 ⇒
    # the ray parameter equals camera depth).
    r_inv = linalg.gauss_inv(r_rows)  # (H, 3, 3)
    o = -jnp.einsum("hij,hj->hi", r_inv, t_rows, precision=_HI)  # (H, 3)
    d_world = jnp.einsum("hij,hwj->hwi", r_inv, d_cam,
                         precision=_HI)  # (H, W, 3)
    origin = jnp.broadcast_to(o[:, None, :], d_world.shape)
    tgrid = None
    if times is not None:
        tgrid = jnp.broadcast_to(times[:, None], d_world.shape[:2])
    depth, world, color, hit, mover = _intersect(
        scene, origin, d_world, time=tgrid)
    return color, depth, world, mover


def render_pair(
    scene: Scene,
    intr: Intrinsics,
    rows: int,
    cols: int,
    *,
    gamma: float,
    k: float,
    v,
    w,
    r0=None,
    t0=None,
    dtype=jnp.float32,
) -> SyntheticPair:
    """Render a two-frame RS pair with complete ground truth.

    Args:
      scene: the world geometry.
      intr: pinhole intrinsics.
      rows, cols: image size (rows = number of scanlines H).
      gamma: readout ratio T_a/(T_a+T_b).
      k: acceleration factor of the motion model.
      v: (3,) linear velocity, world units per frame interval.
      w: (3,) angular velocity, radians per frame interval.
      r0, t0: optional initial world→camera pose (default identity/zero, i.e.
        the world frame IS frame-1 scanline 0's camera frame).

    Returns:
      SyntheticPair with RS/GS images, GT depth, unprojection maps, and
      per-scanline GT poses for both frames.
    """
    v = jnp.asarray(v, dtype=dtype)
    w = jnp.asarray(w, dtype=dtype)
    r0 = jnp.eye(3, dtype=dtype) if r0 is None else jnp.asarray(r0, dtype)
    t0 = jnp.zeros(3, dtype=dtype) if t0 is None else jnp.asarray(t0, dtype)

    idx = jnp.arange(rows, dtype=dtype)
    frames = []
    for beta_fn in (beta1, beta2):
        betas = beta_fn(idx, rows, gamma, k)
        r_rows, t_rows = _row_poses(r0, t0, v, w, betas)
        # Moving primitives are displaced by the same β-parameterized time
        # the camera trajectory uses (their velocity is per frame interval).
        rs_img, rs_depth, rs_unproj, rs_mover = _render(
            scene, intr, rows, cols, r_rows, t_rows, dtype, times=betas)
        # GS image at this frame's scanline-0 pose (and instant).
        r_gs = jnp.broadcast_to(r_rows[0], (rows, 3, 3))
        t_gs = jnp.broadcast_to(t_rows[0], (rows, 3))
        gs_img, gs_depth, gs_unproj, _ = _render(
            scene, intr, rows, cols, r_gs, t_gs, dtype,
            times=jnp.broadcast_to(betas[0], (rows,)))
        frames.append(SyntheticFrame(
            rs_image=rs_img, gs_image=gs_img,
            rs_depth=rs_depth, gs_depth=gs_depth,
            rs_unproject=rs_unproj, gs_unproject=gs_unproj,
            poses_r=r_rows, poses_t=t_rows, mover_mask=rs_mover))
    return SyntheticPair(
        frame1=frames[0], frame2=frames[1], intrinsics=intr,
        gamma=gamma, k=k, v=v, w=w)


def stress_scene(dtype=jnp.float32, *, mover_speed=0.8,
                 foreground=True) -> Scene:
    """Castle scene + rigidity breakers: the real-imagery stress bed.

    Adds to castle_scene:
      * a NEAR foreground slab (depth ~1.8 vs scene mean ~6 — the strong
        depth-discontinuity / large-parallax case);
      * two independently moving occluders crossing the view (world
        velocity `mover_speed` units per frame interval, one lateral, one
        diagonal-towards) — the reference's dominant real-world failure
        mode (examples/README.md:14: moving objects corrupt DeepFlow and
        everything downstream).

    Pixels on movers are flagged in SyntheticFrame.mover_mask, so tests can
    check they are excluded by FB-occlusion masking / RANSAC.
    """
    base = castle_scene(dtype=dtype)
    extra = [
        # foreground slab, bottom-left quadrant, very close
        ([-1.6, 0.45, 1.8], [0.9, 0.0, 0.0], [0.0, 0.75, 0.0],
         [0.85, 0.55, 0.35], [0.0, 0.0, 0.0]),
        # lateral mover: small card sweeping left→right mid-frame
        ([-0.55, -0.35, 3.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0],
         [0.25, 0.75, 0.9], [mover_speed, 0.0, 0.0]),
        # diagonal mover: drifting down-right and toward the camera
        ([0.35, -1.05, 4.2], [0.65, 0.0, 0.0], [0.0, 0.65, 0.0],
         [0.9, 0.35, 0.4], [-0.5 * mover_speed, 0.35 * mover_speed,
                            -0.4 * mover_speed]),
    ]
    if not foreground:
        extra = extra[1:]
    o = jnp.concatenate([base.origins,
                         jnp.asarray([e[0] for e in extra], dtype)])
    e1 = jnp.concatenate([base.edge1,
                          jnp.asarray([e[1] for e in extra], dtype)])
    e2 = jnp.concatenate([base.edge2,
                          jnp.asarray([e[2] for e in extra], dtype)])
    c = jnp.concatenate([base.base_color,
                         jnp.asarray([e[3] for e in extra], dtype)])
    vel = jnp.concatenate([jnp.zeros_like(base.origins),
                           jnp.asarray([e[4] for e in extra], dtype)])
    return Scene(origins=o, edge1=e1, edge2=e2, base_color=c, velocity=vel)


def apply_photometric(image, key, *, exposure=1.0, gamma_curve=1.0,
                      vignette=0.0, noise_sigma=0.0, blur=False,
                      motion_blur_px=0.0, motion_blur_dir=(1.0, 0.35),
                      jpeg_quality=0, demosaic=False):
    """Photometric + camera-pipeline nuisances for stress testing.

    Models the real-camera effects the brightness-constancy data term
    breaks on (and the census/structure-texture terms are built for):
    global exposure/gain change, tone-curve (gamma) shift, radial
    vignetting, sensor noise, a mild 3x3 defocus blur, and (r5, VERDICT
    r4 item 9) the sensor-pipeline artifacts of real footage:

      * motion_blur_px — per-scanline exposure-window streak: a
        box-filter streak of this length (px) along motion_blur_dir,
        the dominant degradation of hand-held RS video;
      * jpeg_quality — 8x8-block DCT quantization (1..100, 0 = off):
        a faithful luma-channel JPEG quantization pass (standard
        Annex-K table scaled by quality) introducing the blocking/
        ringing of compressed camera output;
      * demosaic — Bayer RGGB sampling + bilinear demosaic: each
        channel is sampled on its Bayer sites and re-interpolated,
        reproducing the channel-dependent resolution loss and
        zipper artifacts of single-sensor color.

    Args:
      image: (H, W, 3) float in [0, 1].
      key: PRNG key (used for the noise only).
    """
    img = jnp.asarray(image)
    dtype = img.dtype
    h, w = img.shape[:2]
    out = img * jnp.asarray(exposure, dtype)
    if gamma_curve != 1.0:
        out = jnp.clip(out, 1e-6, 1.0) ** jnp.asarray(gamma_curve, dtype)
    if vignette:
        ys, xs = jnp.meshgrid(jnp.arange(h, dtype=dtype),
                              jnp.arange(w, dtype=dtype), indexing="ij")
        r2 = (((xs - w / 2) / (w / 2)) ** 2
              + ((ys - h / 2) / (h / 2)) ** 2) / 2.0
        out = out * (1.0 - jnp.asarray(vignette, dtype) * r2)[..., None]
    if motion_blur_px > 0.0:
        # Box streak of `motion_blur_px` along the (unit-normalized)
        # direction: average of S uniformly spaced sub-exposure samples
        # (rolled copies — exact for integer sub-shifts, bilinear pairs
        # otherwise rounded to nearest; S scales with the length).
        d = np.asarray(motion_blur_dir, np.float64)
        d = d / max(np.linalg.norm(d), 1e-9)
        s_count = max(int(np.ceil(motion_blur_px)) + 1, 2)
        taps = []
        for s_i in range(s_count):
            frac = s_i / (s_count - 1) - 0.5
            dx = int(round(frac * motion_blur_px * d[0]))
            dy = int(round(frac * motion_blur_px * d[1]))
            taps.append(jnp.roll(out, (dy, dx), (0, 1)))
        out = sum(taps) / float(s_count)
    if blur:
        kern = jnp.asarray([0.25, 0.5, 0.25], dtype)
        for axis in (0, 1):
            shifted = sum(
                k * jnp.roll(out, sh, axis=axis)
                for k, sh in zip(kern, (-1, 0, 1)))
            out = shifted
    if demosaic:
        out = _bayer_demosaic(out)
    if noise_sigma:
        out = out + noise_sigma * jax.random.normal(key, out.shape, dtype)
    out = jnp.clip(out, 0.0, 1.0)
    if jpeg_quality:
        out = _jpeg_quantize(out, int(jpeg_quality))
    return jnp.clip(out, 0.0, 1.0)


def _bayer_demosaic(img):
    """RGGB Bayer sampling + bilinear demosaic (channel-dependent
    resolution loss + zipper edges, the single-sensor color artifact)."""
    dtype = img.dtype
    h, w = img.shape[:2]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    even_y = (ys % 2) == 0
    even_x = (xs % 2) == 0
    r_site = even_y & even_x
    b_site = ~even_y & ~even_x
    g_site = ~(r_site | b_site)

    def fill(chan, site):
        # Normalized-convolution bilinear fill from the channel's sites
        # (edge-clamped shifts: roll would wrap opposite borders in).
        m = site.astype(dtype)
        v = chan * m
        k = jnp.asarray([0.5, 1.0, 0.5], dtype)

        def shift1(x, s, axis):
            if s == 0:
                return x
            n = x.shape[axis]
            if s > 0:
                body = jax.lax.slice_in_dim(x, 0, n - s, axis=axis)
                edge = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
                return jnp.concatenate([edge] * s + [body], axis=axis)
            body = jax.lax.slice_in_dim(x, -s, n, axis=axis)
            edge = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
            return jnp.concatenate([body] + [edge] * (-s), axis=axis)

        def blur1(x, axis):
            return sum(kk * shift1(x, sh, axis)
                       for kk, sh in zip(k, (-1, 0, 1)))

        num = blur1(blur1(v, 0), 1)
        den = blur1(blur1(m, 0), 1)
        return num / jnp.maximum(den, 1e-6)

    return jnp.stack([fill(img[..., 0], r_site),
                      fill(img[..., 1], g_site),
                      fill(img[..., 2], b_site)], axis=-1)


# Standard JPEG luminance quantization table (Annex K).
_JPEG_Q = np.asarray([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float64)


def _jpeg_quantize(img, quality: int):
    """Per-channel 8x8 DCT quantization at the given JPEG quality.

    The standard quality->scale map (libjpeg): q<50 -> 5000/q,
    q>=50 -> 200-2q, table clipped to >=1.  Applied per channel in RGB
    (a luma/chroma split would need 4:2:0 subsampling too; the blocking
    and ringing — what the flow data term sees — are already faithful).
    """
    h, w = img.shape[:2]
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    q = np.maximum(np.floor((_JPEG_Q * scale + 50.0) / 100.0), 1.0)
    hp = (-h) % 8
    wp = (-w) % 8
    x = jnp.pad(img, ((0, hp), (0, wp), (0, 0)), mode="edge")
    hh, ww = x.shape[:2]
    dtype = img.dtype

    # Type-II orthonormal DCT basis (8x8).
    n_idx = np.arange(8)
    c = np.sqrt(2.0 / 8.0) * np.cos(
        np.pi * (2 * n_idx[None, :] + 1) * n_idx[:, None] / 16.0)
    c[0, :] = np.sqrt(1.0 / 8.0)
    cb = jnp.asarray(c, dtype)
    qb = jnp.asarray(q, dtype)

    blocks = (x * 255.0 - 128.0).reshape(hh // 8, 8, ww // 8, 8, 3)
    blocks = blocks.transpose(0, 2, 4, 1, 3)      # (BH, BW, 3, 8, 8)
    coef = jnp.einsum("ij,...jk,lk->...il", cb, blocks, cb, precision=_HI)
    coef = jnp.round(coef / qb) * qb
    rec = jnp.einsum("ji,...jk,kl->...il", cb, coef, cb, precision=_HI)
    rec = rec.transpose(0, 3, 1, 4, 2).reshape(hh, ww, 3)
    return jnp.clip((rec + 128.0) / 255.0, 0.0, 1.0)[:h, :w]


def default_intrinsics(rows: int, cols: int) -> Intrinsics:
    """Square-pixel intrinsics with ~53° horizontal FoV, centered."""
    f = float(cols)
    return Intrinsics(fx=f, fy=f, cx=cols / 2.0 - 0.5, cy=rows / 2.0 - 0.5)
