"""Sparse matrix containers (pytrees) and host-side builders.

The reference stores matrices as ``sprs`` CSR/CSC (``src/mat.rs:47``).  Here
the *storage* format and the *execution* format are deliberately decoupled:

- :class:`COO` / :class:`CSR` — canonical build/interchange formats.
- :class:`ELL` — row-padded format; the general execution layout (regular
  shape, vectorizable gather).
- :class:`DIA` — diagonal/banded format; the fast path for stencil matrices
  (grid Laplacians): x-gathers become contiguous shifted slices, which is the
  speed-of-light layout.

All containers are registered pytrees, so they pass through ``jax.jit``,
``lax.while_loop`` carries and ``shard_map`` untouched.
"""

from .bsr import BSR, ComplexBSR
from .containers import COO, CSC, CSR, ELL, DIA, csr_from_bcoo, csr_from_scipy, csr_from_dense, reorder_rcm

__all__ = ["BSR", "ComplexBSR", "COO", "CSC", "CSR", "ELL", "DIA", "csr_from_bcoo", "csr_from_scipy", "csr_from_dense", "reorder_rcm"]
