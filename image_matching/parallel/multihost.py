"""Multi-host initialization (the network across hosts, NVLink within one).

The reference is strictly single-node (SURVEY.md section 2.6); this is the
scale-out story: `init()` wires jax.distributed so a mesh built from
jax.devices() spans all hosts, and ShardedScenario then shards the
encrypted DB's group axis across every card of every host.  Host-level
enrollment partitions rows so each host encrypts only its own DB shard.
"""

from __future__ import annotations

import jax
import numpy as np


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None):
    """Initialize jax.distributed from explicit args or the standard env
    (JAX_COORDINATOR_ADDRESS etc.).  No-op on a single process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "db"):
    """1-D mesh over every device in the slice (all hosts)."""
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def local_rows(total_rows: int) -> slice:
    """Row range of the DB this host should enroll (equal contiguous
    shards by process index)."""
    p = jax.process_index()
    np_ = jax.process_count()
    per = (total_rows + np_ - 1) // np_
    return slice(p * per, min((p + 1) * per, total_rows))
