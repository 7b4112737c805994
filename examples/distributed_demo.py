"""Distributed solve walkthrough on a virtual 8-device CPU mesh.

Shows the row-partitioning strategies and that the same solver code runs
on one device and on a mesh. On real cards, drop the CPU overrides and pass
a mesh over `jax.devices()` (``python chip_smoke.py --four-cards`` does so
at 10M rows).

Run: python examples/distributed_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

import sprsolve_tpu as sp
from sprsolve_tpu.parallel import (
    distributed_solve,
    partition_csr,
    partition_dia,
)
from sprsolve_tpu.utils import problems


def main():
    print(f"devices: {len(jax.devices())}")
    A = problems.poisson3d(16, 16, 16, dtype=np.float64)  # 4096 rows
    n = A.shape[0]
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(n))
    M = sp.DiagPrecond.new(np.asarray(A.diagonal()))

    def check(name, x, info):
        r = np.asarray(A.matvec(x)) - np.asarray(b)
        rel = np.linalg.norm(r) / np.linalg.norm(np.asarray(b))
        print(f"{name:28s}: {int(info.iterations):4d} iters, true rel res {rel:.2e}")

    # 1. general sparsity: all-gather halo exchange
    x, info = distributed_solve(sp.bicgstab, A, b, M=M, tol=1e-12, max_iter=500)
    check("AllGatherELL + Jacobi", x, info)

    # 2. banded: neighbor ppermute halo (boundary slices only)
    x, info = distributed_solve(sp.bicgstab, A.to_dia(), b, M=M, tol=1e-12, max_iter=500)
    check("HaloDIA + Jacobi", x, info)

    # same solver, single-chip, for comparison
    x, info = sp.bicgstab(A.to_dia(), b, M=M, tol=1e-12, max_iter=500)
    check("single-device DIA", x, info)


if __name__ == "__main__":
    main()
