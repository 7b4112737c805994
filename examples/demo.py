"""Demo — port of the reference binary (``src/main.rs:4-36``): build a 4×4
Dirichlet grid Laplacian, print its nnz pattern, set boundary rhs, run one
SpMV, then go further than the reference's commented-out section and actually
solve with BiCGStab.

Run: python examples/demo.py   (CPU is fine; no accelerator required)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.utils import problems


def nnz_pattern(csr: sp.CSR) -> str:
    """ASCII nnz pattern (the sprs::visu::nnz_pattern_formatter analog)."""
    dense = np.asarray(csr.todense())
    return "\n".join(
        "".join("x" if v != 0 else "." for v in row) for row in dense
    )


def main():
    shape = (4, 4)
    lap = problems.grid_laplacian_dirichlet(shape)
    print(f"grid laplacian nnz structure:\n{nnz_pattern(lap)}")

    rhs = np.zeros(16)
    problems.set_boundary_condition(rhs, shape, lambda r, c: float(r + c))

    y = np.asarray(lap.matvec(rhs))
    print("\nA @ rhs =", np.array2string(y, precision=3))

    x, (iters, res) = sp.BiCGStab.new(lap, 16).solve(rhs, max_iter=300, tol=1e-14)
    print(f"\nBiCGStab solved in {iters} iterations, relative residual {res:.2e}")
    for i in range(shape[0]):
        print(" ".join(f"{np.asarray(x)[i * shape[1] + j]:7.3f}" for j in range(shape[1])))


if __name__ == "__main__":
    main()
