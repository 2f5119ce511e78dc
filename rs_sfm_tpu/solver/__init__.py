"""Estimation engines: β factors, batched 9-point minimal solver, k
estimation, vectorized RANSAC, closed-form per-pixel depth, Schur-reduced
Levenberg–Marquardt joint refinement.

JAX replacement for the reference's L3 layer (src/minimal.{h,cc},
src/nonlinearRefinement.{h,cc}).  All functions work on full fixed-shape
pixel grids with validity masks (no compaction) so everything jits, vmaps
over frame pairs, and shards over pixels.
"""

from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k, beta_factor
from rs_sfm_tpu.solver.flow_model import predict_flow, flow_residual
from rs_sfm_tpu.solver.minimal import calculate_velocities
from rs_sfm_tpu.solver.depth import estimate_inverse_depth
from rs_sfm_tpu.solver.ransac import ransac, RansacResult
from rs_sfm_tpu.solver.refine import refine, RefineResult
