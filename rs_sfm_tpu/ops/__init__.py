"""Compute primitives: batched small-matrix linear algebra and the fused
SOR kernel (sor_cuda).

The reference leans on Eigen (JacobiSVD, SelfAdjointEigenSolver, EigenSolver,
matrix inverses — reference src/minimal.cc:56-113) for its tiny-core linear
algebra.  General nonsymmetric eigendecomposition is not available inside
XLA on accelerators, and batched tiny-matrix solves are faster as fused
elementwise code, so this package provides fully batched, vmap/jit-friendly
implementations built from elementwise ops — they run identically on GPU,
CPU and inside shard_map, with no host callbacks:

  linalg.eigh_small      cyclic-Jacobi symmetric eigendecomposition
  linalg.null_vector     smallest right-singular vector via eigh(ZᵀZ)
  linalg.gauss_det       determinant by partially pivoted elimination
  linalg.gauss_solve     linear solve by partially pivoted elimination
  linalg.gauss_inv       inverse by Gauss-Jordan
  linalg.polyroots       Durand–Kerner simultaneous root iteration
"""
