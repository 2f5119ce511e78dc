"""Multi-process runtime initialization.

The reference has no distributed runtime at all (single process,
src/main.cc:133-142).  This framework scales across processes with
jax.distributed: every process runs the same program and the mesh spans
all devices.  On GPUs XLA hands the collectives the solver emits (psum'd
Schur systems, RANSAC votes, metric reductions) to NCCL, which runs them
over NVLink between the cards of one host and over the network between
hosts.  One process can also drive all the cards of a host on its own,
with no initialization at all.

Typical launch (one command per process):

    python -m rs_sfm_tpu.cli sweep --path ... \
        --coordinator host0:1234 --num-hosts 4 --host-id $ID

or, with no arguments, a cluster environment JAX detects (e.g. SLURM or
Open MPI variables).
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               timeout: int = 300) -> None:
    """Join the multi-process runtime.

    With no arguments, joins the cluster JAX detects from the environment,
    and stays single-process when it detects none.  With explicit
    arguments any failure raises, e.g. a coordinator that cannot be
    reached within `timeout` seconds.
    """
    if coordinator is None and num_processes is None and process_id is None:
        try:
            jax.distributed.initialize(initialization_timeout=timeout)
        except ValueError:
            # No cluster environment: the coordinator address, process
            # count or id is undefined.  Single-process run.
            return
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            initialization_timeout=timeout)


def global_mesh(pairs: Optional[int] = None):
    """(pairs, pixels) mesh over every device of every process.

    Defaults to data-parallel over processes (pairs = process count) with
    pixel/scanline sharding within each process's devices: the
    independent pairs cross the slower inter-host links, while the chatty
    Schur/vote psums stay between the cards of one host.
    """
    from rs_sfm_tpu.parallel.mesh import make_mesh

    if pairs is None:
        pairs = max(jax.process_count(), 1)
    return make_mesh(pairs=pairs)
