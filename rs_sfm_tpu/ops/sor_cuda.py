"""Fused multi-sweep red-black SOR on a GPU (CUDA through jax.ffi).

`sor_sweeps` runs the flow solver's `iters` red-black sweeps
(flow/dense.py sor_sweeps_xla) in launches of TILE_SWEEPS sweeps each.
A launch gives every TILE_Y x TILE_X tile of the image one block, which
loads the tile plus a halo of 2·s rows and columns of all planes into
shared memory, runs s sweeps there and writes back the interior only
(native/sor_cuda.cu).  The XLA loop moves every plane through device
memory on each half-sweep; here the planes are read once per launch.

Exactness: the 4-neighbour stencil's dependence cone grows one pixel per
color, so after s sweeps every pixel further than 2·s from the window
edge equals what s global sweeps give.  The Neumann boundary is applied
at the global image edges; window pixels outside the image are loaded
edge-clamped and never updated or read by image pixels.  The colour is
the global (y + x) parity.  `sor_sweeps_tiled` replays this schedule in
jax.numpy, so the CPU tests check the argument against the XLA loop;
the kernel itself exists only on the card.

The shared library is built from native/sor_cuda.cu with nvcc on first
use into native/build/ (ahead of time: `build()`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

import jax
import jax.numpy as jnp

# Must match native/sor_cuda.cu.
TILE_Y = 32
TILE_X = 64
TILE_SWEEPS = 4

_TARGET = "rs_sor_sweeps"
_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE, "sor_cuda.cu")
_LIB = os.path.join(_NATIVE, "build", "libsor_cuda.so")
_LOCK = threading.Lock()
_registered = False


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the SOR kernel needs the CUDA "
                           "toolkit to build native/sor_cuda.cu")
    return path


def build() -> str:
    """Compile native/sor_cuda.cu for Hopper (sm_90a) unless the library
    is newer than the source; returns the library path."""
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.tmp"
    subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-I", jax.ffi.include_dir(), "-o", tmp, _SRC],
        check=True, capture_output=True, text=True)
    os.replace(tmp, _LIB)
    return _LIB


def _register() -> None:
    global _registered
    with _LOCK:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.RsSorSweeps), platform="CUDA")
        _registered = True


def sor_sweeps(t, iters: int, cfg):
    """`iters` red-black SOR sweeps from (t.u0, t.v0) on the GPU.

    t: flow.dense.Linearised planes (float32, (H, W)); cfg: the
    DenseFlowConfig whose omega/smoothness/eps/weights apply.  Returns
    (u, v).  Raises on any backend but the GPU: there is no other path
    behind this function.
    """
    if jax.default_backend() != "gpu":
        raise RuntimeError("the fused SOR kernel runs only on a GPU "
                           f"(backend is {jax.default_backend()!r})")
    _register()
    planes = jnp.stack([t.ix, t.iy, t.it, t.ixx, t.ixy, t.iyy, t.gtx,
                        t.gty, t.u0, t.v0]).astype(jnp.float32)
    h, w = t.u0.shape
    out = jax.ShapeDtypeStruct((h, w), jnp.float32)
    u, v, _ = jax.ffi.ffi_call(
        _TARGET, (out, out, jax.ShapeDtypeStruct((2, h, w), jnp.float32)),
        vmap_method="sequential")(
            planes, planes[8], planes[9], iters=np.int32(iters),
            omega=np.float32(cfg.omega), lam=np.float32(cfg.smoothness),
            eps2=np.float32(cfg.eps * cfg.eps),
            wbr=np.float32(cfg.brightness_weight),
            wgrad=np.float32(cfg.gamma_grad))
    return u, v


def sor_sweeps_tiled(t, iters: int, cfg, *, tile_y: int = TILE_Y,
                     tile_x: int = TILE_X, tile_sweeps: int = TILE_SWEEPS):
    """The kernel's tile/halo schedule in jax.numpy (any backend).

    Same launches, windows, clamped loads, boundary rule and parity as
    native/sor_cuda.cu, with the XLA loop's point solve — so it equals
    flow.dense.sor_sweeps_xla to rounding exactly when the schedule is
    exact.  Used by the tests to check that argument.
    """
    from rs_sfm_tpu.flow.dense import Linearised, _point_solve, _shift

    h, w = t.u0.shape
    nby, nbx = -(-h // tile_y), -(-w // tile_x)
    u, v = t.u0, t.v0
    n_full, rem = divmod(iters, tile_sweeps)
    for sweeps in [tile_sweeps] * n_full + ([rem] if rem else []):
        halo = 2 * sweeps
        gy = (jnp.arange(nby)[:, None] * tile_y - halo
              + jnp.arange(tile_y + 2 * halo)[None, :])     # (nby, WY)
        gx = (jnp.arange(nbx)[:, None] * tile_x - halo
              + jnp.arange(tile_x + 2 * halo)[None, :])     # (nbx, WX)
        cy = jnp.clip(gy, 0, h - 1)
        cx = jnp.clip(gx, 0, w - 1)

        def window(a):
            # (nby, nbx, WY, WX) clamped tile windows of an (H, W) plane.
            return a[cy[:, None, :, None], cx[None, :, None, :]]

        tw = Linearised(*[window(a) for a in t])
        uw, vw = window(u), window(v)
        yy = gy[:, None, :, None]
        xx = gx[None, :, None, :]
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)

        def navg(z):
            # Window edges clamp (outside the dependence cone); image
            # edges are Neumann.
            up = jnp.where(yy == 0, z, _shift(z, 1, 2))
            dn = jnp.where(yy == h - 1, z, _shift(z, -1, 2))
            lf = jnp.where(xx == 0, z, _shift(z, 1, 3))
            rt = jnp.where(xx == w - 1, z, _shift(z, -1, 3))
            return (up + dn + lf + rt) * 0.25

        for _ in range(sweeps):
            for color in (0, 1):
                u_s, v_s = _point_solve(tw, uw, vw, navg(uw), navg(vw), cfg)
                upd = inside & ((yy + xx) % 2 == color)
                uw = jnp.where(upd, uw + cfg.omega * (u_s - uw), uw)
                vw = jnp.where(upd, vw + cfg.omega * (v_s - vw), vw)

        def interior(z):
            z = z[:, :, halo:halo + tile_y, halo:halo + tile_x]
            return z.transpose(0, 2, 1, 3).reshape(
                nby * tile_y, nbx * tile_x)[:h, :w]

        u, v = interior(uw), interior(vw)
    return u, v
