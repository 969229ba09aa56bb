"""Multi-host (multi-process) bootstrap for the sharded renderer.

The reference is single-GPU/single-process; meshes that span hosts (one
host x 4 devices is one process; >= 2 hosts are several) need a
process-spanning mesh. This module is the
runnable-by-flag scaffolding: ``jax.distributed.initialize`` wiring, a global
mesh over every chip of every process, and host-local -> global array
construction so each host can load its own scene shard.

Everything downstream is unchanged: ``parallel.fast_sharded`` runs under
``shard_map`` over whatever mesh it is given, and under jit on a
process-spanning mesh XLA lowers the same ``all_to_all``/``psum``
collectives onto the intra-host and cross-host links automatically.

Smoke-tested by ``tests/test_multihost.py``: two CPU-backend processes
coordinate over localhost, build a 2-process mesh, and run a sharded render
whose result must match single-process rendering.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Connect this process to the cluster (no-op for single-process runs).

    Arguments default to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) so launchers can configure
    ranks purely through the environment; on clusters whose scheduler JAX
    knows (e.g. SLURM), ``jax.distributed.initialize()`` can auto-detect
    them.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        # single-process run (or cluster autodetection explicitly requested
        # via JAX_DIST_AUTODETECT=1)
        if os.environ.get("JAX_DIST_AUTODETECT") == "1":
            jax.distributed.initialize()
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def global_mesh(axis: str = "dev"):
    """1-D mesh over every device of every connected process.

    Device order is jax's global enumeration (process-major), so a splat
    shard's owning process holds its mesh slots contiguously -- host-local
    data placement below stays local.
    """
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def process_count() -> int:
    import jax

    return jax.process_count()


def process_index() -> int:
    import jax

    return jax.process_index()


def host_local_params(params: Dict[str, np.ndarray], mesh, axis: str = "dev"
                      ) -> Dict:
    """Build globally-sharded parameter arrays from *host-local* shards.

    Each process passes only its own slice of the scene (its
    ``1/process_count`` of the splats, already padded so the global count
    divides the mesh); the returned jax Arrays are sharded over ``axis``
    with this host's rows living on this host's devices. Single-process
    meshes degrade to a plain ``device_put``.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return {k: jax.device_put(np.asarray(v), sharding)
                for k, v in params.items()}
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        global_shape = (v.shape[0] * jax.process_count(),) + v.shape[1:]
        out[k] = jax.make_array_from_process_local_data(
            sharding, v, global_shape)
    return out
