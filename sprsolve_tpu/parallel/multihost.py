"""Multi-host entry points: process initialization, DCN-aware meshes, and
host↔global array movement.

The reference has no distributed backend at all (SURVEY.md §2 "Distributed
communication backend: absent"); SURVEY §5 maps that absence to first-class
scaffolding: ``jax.distributed`` initialization for multi-host runs, a row
mesh laid out so that halo ``ppermute`` traffic between adjacent row blocks
stays on intra-host links wherever possible and crosses hosts only at host
boundaries, and helpers to build/collect globally-sharded
arrays from per-process host data.

On a real cluster, ``initialize()`` is a thin wrapper over
``jax.distributed.initialize``.  The
same code paths are exercised hermetically in CI by a 2-process × 4-device
CPU cluster using the Gloo collectives backend
(``tests/test_multihost.py``), the multi-process analog of the virtual
8-device mesh used by the single-process distributed tests.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    cpu_devices_per_process: Optional[int] = None,
) -> None:
    """Join (or auto-detect) the multi-process cluster.

    Where the cluster environment provides them the three arguments may be
    omitted; a GPU host with no cluster manager needs all three (a
    ``localhost:<port>`` coordinator).  For hermetic CPU clusters (tests, local dev), pass
    all three and ``cpu_devices_per_process`` — the CPU backend is switched
    to the Gloo collectives implementation, which supports cross-process
    collectives without hardware interconnect.

    Must be called before any JAX computation creates a backend.
    """
    if cpu_devices_per_process is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(cpu_devices_per_process))
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    jax.distributed.initialize(**kwargs)


def global_row_mesh(axis_name: str = "rows") -> Mesh:
    """1-D row mesh over every device of every process, DCN-aware.

    Devices are ordered process-major (all of host 0's devices, then host
    1's, ...): adjacent row blocks therefore live on the same host except at
    the ``num_processes - 1`` host boundaries, so the nearest-neighbor halo
    ``ppermute`` of the row-partitioned SpMV crosses DCN exactly once per
    boundary and rides ICI (or shared memory) everywhere else.  Krylov inner
    products are ``psum`` trees, which XLA already hierarchically reduces
    (intra-host first) on hybrid ICI/DCN topologies.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), (axis_name,))


def host_to_global(x, mesh: Mesh, spec: P) -> jax.Array:
    """Build a globally-sharded array from a host array every process holds.

    Each process materializes only its addressable shards (the callback is
    invoked per local device with that device's global index slice), so a
    row-partitioned problem can exceed single-host memory as long as each
    host's row block fits.
    """
    arr = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def replicate(x: jax.Array, mesh: Mesh) -> jax.Array:
    """All-gather a sharded global array into a replicated (hence fully
    process-addressable) one — the collective form of ``device_put`` that
    works across processes."""
    return jax.jit(lambda v: v, out_shardings=NamedSharding(mesh, P()))(x)


def fetch(x: jax.Array) -> np.ndarray:
    """Bring a global array fully to the local host (replicating first if
    it is not fully addressable)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)
