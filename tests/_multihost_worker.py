"""Worker process for the hermetic multi-host test (not a test module).

Launched N times by tests/test_multihost.py with distinct process ids; each
process owns 4 virtual CPU devices and joins a Gloo cluster, so the global
mesh spans 2 processes × 4 devices — the same code paths (global mesh,
``host_to_global`` placement, cross-process psum/ppermute inside shard_map,
final all-gather) that a real multi-host GPU cluster run takes.
"""

import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import jax

from sprsolve_tpu.parallel import multihost

multihost.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc,
    process_id=pid,
    cpu_devices_per_process=4,
)
jax.config.update("jax_enable_x64", True)

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())

import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.parallel import distributed_solve
from sprsolve_tpu.utils import problems

mesh = multihost.global_row_mesh("rows")
assert mesh.shape["rows"] == 4 * nproc

A = problems.poisson3d(10, 10, 10, dtype=np.float64)
dia = A.to_dia()
rng = np.random.default_rng(0)
b = rng.standard_normal(1000)
M = sp.DiagPrecond.new(np.asarray(dia.diagonal()))

x, info = distributed_solve(
    sp.bicgstab, dia, jnp.asarray(b), M=M, tol=1e-12, max_iter=500, mesh=mesh
)
status = int(multihost.fetch(info.status).ravel()[0])
iters = int(multihost.fetch(info.iterations).ravel()[0])
assert status == 0, f"status={status}"

xh = multihost.fetch(x)
res = np.linalg.norm(np.asarray(A.matvec(jnp.asarray(xh))) - b) / np.linalg.norm(b)
assert res < 1e-10, res

# MINRES across processes too (symmetric system, no precond)
x2, info2 = distributed_solve(
    sp.minres, dia, jnp.asarray(b), tol=1e-10, max_iter=400, mesh=mesh
)
assert int(multihost.fetch(info2.status).ravel()[0]) == 0
xh2 = multihost.fetch(x2)
res2 = np.linalg.norm(np.asarray(A.matvec(jnp.asarray(xh2))) - b) / np.linalg.norm(b)
assert res2 < 1e-8, res2

print(f"proc {pid}: OK bicgstab iters={iters} res={res:.3e} minres res2={res2:.3e}", flush=True)
