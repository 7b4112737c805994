"""Test/benchmark problem generators.

NumPy ports of the reference test matrices so the framework is validated
on the *same* systems at the same tolerances:

- :func:`grid_laplacian_dirichlet` + :func:`set_boundary_condition` — the
  Dirichlet 5-point grid Laplacian of ``tests/test_solvers.rs:74-124``
  (identity rows on the border, stencil interior).
- :func:`sym_grid_laplacian` — the symmetric Laplacian with boundary terms
  folded into the rhs, ``tests/test_minres.rs:76-120``.
- :func:`simple_diag_system` — the diagonal sanity system,
  ``tests/test_minres.rs:62-74``.
- :func:`hermitian_grid` / :func:`hermitian_grid_with_diag` — the complex
  Hermitian grid operator with a manufactured solution x[vid] = row + col·i,
  ``tests/test_complex_solve.rs:95-214``.
- :func:`complex_symmetric_grid_with_diag` — the complex-*symmetric*
  (non-Hermitian) variant, ``tests/test_complex_solve2.rs:35-96``.
- :func:`poisson3d` — 7-point 3-D Poisson (vectorized; used for the
  10M-row card check in ``chip_smoke.py``).

All builders return NumPy/CSR data; convert with ``CSR.from_arrays`` /
``csr_from_scipy`` or the provided helpers.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from ..sparse.containers import COO, CSR



def _coo_to_csr(rows, cols, vals, n, dtype) -> CSR:
    # keep the build entirely host-side: placing the triplets on the device
    # just to read them back for sorting wastes transfers (and some backends
    # can't transfer every dtype back)
    coo = COO(
        data=np.asarray(vals, dtype=dtype),
        row=np.asarray(rows, dtype=np.int32),
        col=np.asarray(cols, dtype=np.int32),
        shape=(n, n),
    )
    return CSR.from_coo(coo)


def is_border(row: int, col: int, shape: Tuple[int, int]) -> bool:
    rows, cols = shape
    return row == 0 or row + 1 == rows or col == 0 or col + 1 == cols


def grid_laplacian_dirichlet(shape: Tuple[int, int], dtype=np.float64) -> CSR:
    """Dirichlet grid Laplacian (``tests/test_solvers.rs:74-109``): identity
    rows on the border, 5-point stencil (-4 center, +1 neighbors) interior."""
    rows, cols = shape
    n = rows * cols
    ri, ci, vv = [], [], []
    for i in range(rows):
        for j in range(cols):
            vid = i * cols + j
            if is_border(i, j, shape):
                ri.append(vid)
                ci.append(vid)
                vv.append(1.0)
            else:
                for (ti, tj, val) in (
                    (i - 1, j, 1.0),
                    (i, j - 1, 1.0),
                    (i, j, -4.0),
                    (i, j + 1, 1.0),
                    (i + 1, j, 1.0),
                ):
                    ri.append(vid)
                    ci.append(ti * cols + tj)
                    vv.append(val)
    return _coo_to_csr(ri, ci, vv, n, dtype)


def set_boundary_condition(
    rhs: np.ndarray, grid_shape: Tuple[int, int], f: Callable[[int, int], float]
) -> np.ndarray:
    """Set rhs entries on the border (``tests/test_solvers.rs:111-124``)."""
    rows, cols = grid_shape
    for i in range(rows):
        for j in range(cols):
            if is_border(i, j, grid_shape):
                rhs[i * cols + j] = f(i, j)
    return rhs


def sym_grid_laplacian(
    shape: Tuple[int, int], dtype=np.float64
) -> Tuple[CSR, np.ndarray]:
    """Symmetric grid Laplacian with boundary folded into rhs
    (``tests/test_minres.rs:76-120``). Boundary value bv(r,c) = r + c."""
    rows, cols = shape
    n = rows * cols
    rhs = np.zeros(n, dtype=dtype)
    ri, ci, vv = [], [], []
    bv = lambda r, c: float(r + c)
    for i in range(rows):
        for j in range(cols):
            vid = i * cols + j
            ri.append(vid); ci.append(vid); vv.append(-4.0)
            if i > 0:
                ri.append(vid); ci.append((i - 1) * cols + j); vv.append(1.0)
            else:
                rhs[vid] -= bv(i - 1, j)
            if j > 0:
                ri.append(vid); ci.append(i * cols + j - 1); vv.append(1.0)
            else:
                rhs[vid] -= bv(i, j - 1)
            if i < rows - 1:
                ri.append(vid); ci.append((i + 1) * cols + j); vv.append(1.0)
            else:
                rhs[vid] -= bv(i + 1, j)
            if j < cols - 1:
                ri.append(vid); ci.append(i * cols + j + 1); vv.append(1.0)
            else:
                rhs[vid] -= bv(i, j + 1)
    return _coo_to_csr(ri, ci, vv, n, dtype), rhs


def simple_diag_system(
    shape: Tuple[int, int], dtype=np.float64
) -> Tuple[CSR, np.ndarray]:
    """Diagonal system: a_ii = 2(i+1), b_i = i+1 (``tests/test_minres.rs:62-74``)."""
    rows, cols = shape
    n = rows * cols
    idx = np.arange(n)
    rhs = (idx + 1).astype(dtype)
    return _coo_to_csr(idx, idx, (idx + 1) * 2.0, n, dtype), rhs


def _complex_grid(
    shape: Tuple[int, int],
    off_diag: Callable[[int, int], complex],
    diag_fn: Callable[[int, int], complex],
    dtype=np.complex128,
):
    """Shared builder for the manufactured-solution complex grids: the rhs is
    accumulated as A·x_known with x_known[vid] = row + col·i, term by term in
    the same order as the reference (``tests/test_complex_solve.rs:109-149``)."""
    rows, cols = shape
    n = rows * cols
    rhs = np.zeros(n, dtype=dtype)
    diag = np.zeros(n, dtype=dtype)
    ri, ci, vv = [], [], []
    val = lambda r, c: complex(r, c)
    for i in range(rows):
        for j in range(cols):
            vid = i * cols + j
            rv = 0.0 + 0.0j
            c = diag_fn(i, j)
            diag[vid] = c
            ri.append(vid); ci.append(vid); vv.append(c)
            rv += c * val(i, j)
            neighbors = []
            if i > 0:
                neighbors.append(((i - 1) * cols + j, i - 1, j))
            if j > 0:
                neighbors.append((i * cols + j - 1, i, j - 1))
            if i < rows - 1:
                neighbors.append(((i + 1) * cols + j, i + 1, j))
            if j < cols - 1:
                neighbors.append((i * cols + j + 1, i, j + 1))
            for tid, ti, tj in neighbors:
                cv = off_diag(vid, tid)
                ri.append(vid); ci.append(tid); vv.append(cv)
                rv += cv * val(ti, tj)
            rhs[vid] = rv
    return _coo_to_csr(ri, ci, vv, n, dtype), rhs, diag


def hermitian_grid(shape, dtype=np.complex128) -> Tuple[CSR, np.ndarray]:
    """Hermitian grid operator (``tests/test_complex_solve.rs:95-151``):
    off-diagonals (1 ± 2.5i) in conjugate pairs, real diagonal −3 − row."""
    A, rhs, _ = _complex_grid(
        shape,
        off_diag=lambda r, c: (1 + 2.5j) if r > c else (1 - 2.5j),
        diag_fn=lambda i, j: complex(-3.0 - i, 0.0),
        dtype=dtype,
    )
    return A, rhs


def hermitian_grid_with_diag(
    shape, dtype=np.complex128
) -> Tuple[CSR, np.ndarray, np.ndarray]:
    """Same, plus the **real** preconditioner diagonal −Re(a_ii) = 3 + row
    (``tests/test_complex_solve.rs:153-214``)."""
    A, rhs, diag = _complex_grid(
        shape,
        off_diag=lambda r, c: (1 + 2.5j) if r > c else (1 - 2.5j),
        diag_fn=lambda i, j: complex(-3.0 - i, 0.0),
        dtype=dtype,
    )
    return A, rhs, -diag.real


def complex_symmetric_grid_with_diag(
    shape, dtype=np.complex128
) -> Tuple[CSR, np.ndarray, np.ndarray]:
    """Complex-symmetric (non-Hermitian) grid
    (``tests/test_complex_solve2.rs:35-96``): both off-diagonals (1 − 2.5i),
    complex diagonal (−2 − row) + (−2 − col)·i. Returns (A, rhs, diag)."""
    return _complex_grid(
        shape,
        off_diag=lambda r, c: 1 - 2.5j,
        diag_fn=lambda i, j: complex(-2.0 - i, -2.0 - j),
        dtype=dtype,
    )


def poisson3d(nx: int, ny: int, nz: int, dtype=np.float32) -> CSR:
    """7-point 3-D Poisson operator with Dirichlet elimination (interior-only
    unknowns), fully vectorized — used for the 1M-row bench and the
    10M-row card check (BASELINE.md config #4)."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    iz = idx % nz
    iy = (idx // nz) % ny
    ix = idx // (nz * ny)

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 6.0, dtype=dtype)]

    for delta, mask in (
        (-nz * ny, ix > 0),
        (nz * ny, ix < nx - 1),
        (-nz, iy > 0),
        (nz, iy < ny - 1),
        (-1, iz > 0),
        (1, iz < nz - 1),
    ):
        rows.append(idx[mask])
        cols.append(idx[mask] + delta)
        vals.append(np.full(mask.sum(), -1.0, dtype=dtype))

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    # sort to CSR order without the python-loop COO path (fast for ~1e7 nnz)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR.from_arrays(vals, cols.astype(np.int32), indptr, (n, n))


def convection_diffusion3d(
    nx: int, ny: int, nz: int, peclet: float = 20.0, dtype=np.float32
) -> CSR:
    """7-point convection-diffusion: −Δu + v·∇u, first-order upwind along x.

    The standard NONSYMMETRIC hard case (no reference analog — the
    reference's nonsymmetric surface is BiCGStab only): at grid Peclet
    number ``peclet`` the x-coupling is strongly one-sided, plain
    restarted GMRES stalls and short-recurrence methods wobble — the
    regime the flexible inner-outer solvers exist for.  Banded (same 7
    offsets as :func:`poisson3d`), so the DIA path serves it.
    """
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    iz = idx % nz
    iy = (idx // nz) % ny
    ix = idx // (nz * ny)

    c = float(peclet)
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 6.0 + c, dtype=dtype)]   # diffusion + upwind diag

    for delta, mask, v in (
        (-nz * ny, ix > 0, -1.0 - c),   # upwind: flow in +x direction
        (nz * ny, ix < nx - 1, -1.0),
        (-nz, iy > 0, -1.0),
        (nz, iy < ny - 1, -1.0),
        (-1, iz > 0, -1.0),
        (1, iz < nz - 1, -1.0),
    ):
        rows.append(idx[mask])
        cols.append(idx[mask] + delta)
        vals.append(np.full(mask.sum(), v, dtype=dtype))

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR.from_arrays(vals, cols.astype(np.int32), indptr, (n, n))
