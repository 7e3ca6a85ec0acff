"""Multi-HOST execution support (SURVEY.md section 7: multi-host parity is
validated against single-host runs via JAX multi-process CPU simulation).

The sharded solvers' compiled code is process-count-agnostic (`shard_map`
over a Mesh); what changes across process boundaries is ARRAY CREATION --
a process can only address its local shards, so host-side numpy operands
must enter through `jax.make_array_from_callback` against the global mesh
sharding, and sharded results must be replicated before a host readback.
This module provides those three primitives plus an initialize wrapper:

    import tfqmrgpu_tpu.parallel.multihost as mh
    mh.initialize("10.0.0.1:1234", num_processes=4, process_id=rank)
    mesh = mh.global_mesh(pr=jax.device_count())
    # ... ShardedBlockListSolver(plan, mesh) works unchanged: it routes
    # its operands through put_global / gather_global.

Every process must execute the same host code (the pack is deterministic,
so all processes compute identical schedules and operands) -- the standard
SPMD multi-host JAX model.
"""

from __future__ import annotations

import numpy as np

import jax


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, **kw) -> None:
    """jax.distributed.initialize wrapper (idempotent)."""
    try:
        jax.distributed.initialize(coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id, **kw)
    except RuntimeError as e:              # already initialized
        if "already" not in str(e).lower():
            raise


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(pr: int, pc: int = 1) -> "jax.sharding.Mesh":
    """(rows, cols) mesh over the GLOBAL device list (all processes)."""
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[: pr * pc]).reshape(pr, pc)
    return Mesh(devs, ("rows", "cols"))


def put_global(arr: np.ndarray, mesh, pspec) -> jax.Array:
    """Host numpy array (identical on every process) -> global device
    array with the given PartitionSpec.  Works single-process too (where
    it is equivalent to device_put)."""
    from jax.sharding import NamedSharding

    arr = np.asarray(arr)
    sh = NamedSharding(mesh, pspec)
    return jax.make_array_from_callback(arr.shape, sh,
                                        lambda idx: arr[idx])


def gather_global(x: jax.Array, mesh) -> np.ndarray:
    """Global (possibly sharded) array -> full numpy array on every
    process: replicate via a resharding jit, then read."""
    from jax.sharding import NamedSharding, PartitionSpec

    rep = NamedSharding(mesh, PartitionSpec())
    return np.asarray(jax.jit(lambda v: v, out_shardings=rep)(x))
