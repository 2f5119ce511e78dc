"""rs_sfm_tpu — rolling-shutter-aware differential SfM in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
C++/Ceres implementation (ThomasZiegler/RS-aware-differential-SfM): given two
consecutive rolling-shutter frames it estimates relative camera motion
(linear velocity v, angular velocity w, optional acceleration factor k) with a
differential 9-point epipolar solver inside a massively vectorized RANSAC,
recovers a per-pixel inverse-depth map in closed form, jointly refines
(v, w, k, depths) with a Schur-reduced Levenberg–Marquardt solver, and
re-renders a rectified global-shutter image via per-scanline pose
interpolation.

Package layout (maps to SURVEY.md §7 build plan):
  geom/      pinhole camera, SO(3), per-scanline RS pose interpolation
  data/      dataset loaders (reference CSV/PNG contract), JAX synthetic
             RS renderer replacing the MATLAB generator, PLY/PNG writers
  flow/      ground-truth flow (scanline-pose argmin) + dense pyramidal flow
  models/    dense optical-flow model families (variational pyramid, ...)
  solver/    beta factors, batched 9-point minimal solver, k estimation,
             vectorized RANSAC, closed-form depth, Schur-LM refinement
  rectify/   z-buffered back-projection scatter, crack fill
  eval/      error metrics + sweep harness (errorMeasure equivalents)
  parallel/  device meshes, shard_map'ed pixel-sharded solver, collectives
  ops/       batched small-matrix linalg + the fused SOR kernel (CUDA)
  utils/     logging, profiling timers, config
"""

from rs_sfm_tpu import config as config

__version__ = "0.1.0"
