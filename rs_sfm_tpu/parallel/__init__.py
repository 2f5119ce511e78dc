"""Parallelism: device meshes, pair-batched and pixel-sharded estimation.

The reference is a single-threaded CPU binary (SURVEY.md §2.4); every
strategy here is a generalization over a `(pairs, pixels)` device mesh:

  * DP  — independent RS frame pairs sharded over the `pairs` axis
          (the batched analog of the reference's sequential task loop,
          src/main.cc:218).
  * TP  — per-pixel work (depth solves, residual/Jacobian products, RANSAC
          scoring) sharded over the `pixels` axis; the reduced 7x7 Schur
          system, RANSAC votes and metrics aggregate via psum.
  * SP  — the domain's sequence axis is the scanline axis: sharding rows
          of the image over `pixels` *is* scanline-block parallelism; the
          only cross-block coupling is the shared (v, w, k) all-reduce.
          Ring-attention/Ulysses do not apply (no attention); this sharding
          fills their role for the scanline sequence.
  * PP  — sliding-window pair pipelining for video (flow(t+1) overlapped
          with solve(t)) via double-buffered batching.
  * EP  — not applicable: the model has no mixture-of-experts component.

Collectives ride XLA (GSPMD inserts them from sharding constraints; the
explicit shard_map path uses lax.psum) over ICI within a slice and DCN
across hosts via jax.distributed.
"""

from rs_sfm_tpu.parallel.mesh import make_mesh
from rs_sfm_tpu.parallel.api import estimate_pairs_batched, estimate_sharded
