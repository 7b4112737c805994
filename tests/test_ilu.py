"""ILU(0) / IC(0): factorization correctness, SPD apply, solver acceleration.

The factorization is the host-side analog of the setup work CPU frameworks do
natively; the apply uses truncated-Neumann triangular sweeps (each sweep one
triangular SpMV), the accelerator formulation of the reference-era sequential
triangular solve.  The reference ships only DiagPrecond (``src/precond.rs``);
these are capability extensions measured against it.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import sprsolve_tpu as sp
from sprsolve_tpu import native
from sprsolve_tpu.errors import InvalidPreconditioner, ZeroDiagonalElem
from sprsolve_tpu.utils import problems


def _csr_parts(A):
    return (
        A.shape[0],
        np.asarray(A.indptr, np.int64),
        np.asarray(A.indices, np.int32),
        np.asarray(A.data),
    )


def _spd_csr(n_side=16, dtype=None):
    A, _ = problems.sym_grid_laplacian((n_side, n_side))
    dense = -np.asarray(A.todense())
    if dtype is not None:
        dense = dense.astype(dtype)
    return sp.csr_from_dense(dense)


def _dense_factors(n, indptr, indices, vals, *, unit_lower):
    L = np.eye(n, dtype=vals.dtype) if unit_lower else np.zeros((n, n), vals.dtype)
    U = np.zeros((n, n), dtype=vals.dtype)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            (L if j < i else U)[i, j] = vals[p]
    return L, U


# ---------------------------------------------------------------- factorization


def test_ilu0_matches_A_on_pattern():
    A = _spd_csr()
    n, indptr, indices, vals = _csr_parts(A)
    f = native.ilu0(n, indptr, indices, vals)
    L, U = _dense_factors(n, indptr, indices, f, unit_lower=True)
    P = L @ U
    dense = np.asarray(A.todense())
    # the defining ILU(0) property: (LU)_ij == A_ij on the sparsity pattern
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            assert abs(P[i, j] - dense[i, j]) < 1e-5 * max(1.0, abs(dense[i, j]))


def test_ilu0_exact_for_fill_free_pattern():
    # tridiagonal: ILU(0) has no dropped fill, so LU == A exactly
    n = 40
    dense = (
        np.diag(np.full(n, 4.0))
        - np.diag(np.ones(n - 1), 1)
        - np.diag(np.ones(n - 1), -1)
    )
    A = sp.csr_from_dense(dense)
    n_, indptr, indices, vals = _csr_parts(A)
    f = native.ilu0(n_, indptr, indices, vals.astype(np.float64))
    L, U = _dense_factors(n_, indptr, indices, f, unit_lower=True)
    np.testing.assert_allclose(L @ U, dense, atol=1e-12)


def test_ic0_matches_A_on_lower_pattern():
    A = _spd_csr()
    n, indptr, indices, vals = _csr_parts(A)
    f = native.ic0(n, indptr, indices, vals)
    Lc, _ = _dense_factors(n, indptr, indices, f, unit_lower=False)
    for i in range(n):  # diagonal lives in the lower factor for IC0
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j > i:
                continue
            Lc[i, j] = f[p]
    P = Lc @ Lc.T.conj()
    dense = np.asarray(A.todense())
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j <= i:
                assert abs(P[i, j] - dense[i, j]) < 1e-5


def test_ilu0_complex():
    rng = np.random.default_rng(3)
    n = 20
    dense = np.diag(4.0 + 1j + rng.random(n)).astype(np.complex128)
    for off in (1, 2):
        v = (rng.random(n - off) + 1j * rng.random(n - off)) * 0.5
        dense += np.diag(v, off) + np.diag(v * 0.7, -off)
    A = sp.csr_from_dense(dense)
    n_, indptr, indices, vals = _csr_parts(A)
    f = native.ilu0(n_, indptr, indices, vals)
    L, U = _dense_factors(n_, indptr, indices, f, unit_lower=True)
    P = L @ U
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            assert abs(P[i, indices[p]] - dense[i, indices[p]]) < 1e-10


def test_ilu0_zero_pivot_raises():
    dense = np.array([[0.0, 1.0], [1.0, 1.0]])
    A = sp.csr_from_dense(dense)
    with pytest.raises(ZeroDiagonalElem):
        sp.ILU0Precond.from_csr(A)


def test_ic0_not_spd_raises():
    dense = np.array([[1.0, 2.0], [2.0, 1.0]])  # indefinite
    A = sp.csr_from_dense(dense)
    with pytest.raises(InvalidPreconditioner):
        sp.IC0Precond.from_csr(A)


def test_native_matches_python_fallback():
    A = _spd_csr(8)
    n, indptr, indices, vals = _csr_parts(A)
    if not native.have_native():
        pytest.skip("no native hostkit in this environment")
    f_native = native.ilu0(n, indptr, indices, vals)
    c_native = native.ic0(n, indptr, indices, vals)
    saved_lib, saved_build = native._lib, native._build
    native._lib, native._build = None, lambda: False
    try:
        f_py = native.ilu0(n, indptr, indices, vals)
        c_py = native.ic0(n, indptr, indices, vals)
    finally:
        native._lib, native._build = saved_lib, saved_build
    # -march=native FMA contraction perturbs the C++ path at ulp level;
    # semantic parity, not bitwise
    np.testing.assert_allclose(f_native, f_py, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(c_native, c_py, rtol=1e-13, atol=1e-15)


# ---------------------------------------------------------------------- apply


def test_ilu0_apply_exact_with_enough_sweeps():
    # with sweeps >= the factor's level depth the truncated-Neumann solves
    # are exact: M^{-1} r == U^{-1} L^{-1} r
    A = _spd_csr(5)  # n = 25: sweeps=n always exact
    n = A.shape[0]
    M = sp.ILU0Precond.from_csr(A, sweeps=n)
    n_, indptr, indices, vals = _csr_parts(A)
    f = native.ilu0(n_, indptr, indices, vals)
    L, U = _dense_factors(n_, indptr, indices, f, unit_lower=True)
    rng = np.random.default_rng(0)
    r = rng.standard_normal(n).astype(np.float32)
    want = np.linalg.solve(U, np.linalg.solve(L, r))
    got = np.asarray(M.matvec(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_ic0_apply_is_spd():
    # the truncated apply must be Hermitian PSD for ANY sweep count — the
    # property MINRES's beta^2 gate depends on
    A = _spd_csr(6)
    n = A.shape[0]
    for sweeps in (1, 2, 5):
        M = sp.IC0Precond.from_csr(A, sweeps=sweeps)
        dense_M = np.column_stack(
            [np.asarray(M.matvec(jnp.eye(n, dtype=jnp.float32)[:, i])) for i in range(n)]
        )
        np.testing.assert_allclose(dense_M, dense_M.T, atol=1e-5)
        w = np.linalg.eigvalsh(0.5 * (dense_M + dense_M.T))
        assert w.min() > 0


# ------------------------------------------------------------------- end-to-end


def test_ilu0_accelerates_bicgstab():
    A = _spd_csr()
    b = jnp.asarray(np.random.default_rng(0).standard_normal(256))
    M = sp.ILU0Precond.from_csr(A, sweeps=3)
    x_p, info_p = sp.bicgstab(A.to_dia(), b, M=M, tol=1e-10, max_iter=2000)
    info_p.raise_if_error()
    _, info_j = sp.bicgstab(A.to_dia(), b, M=sp.DiagPrecond.new(A.diagonal()),
                            tol=1e-10, max_iter=2000)
    info_j.raise_if_error()
    assert int(info_p.iterations) < int(info_j.iterations)
    r = np.asarray(A.matvec(x_p)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-8


def test_ic0_accelerates_minres():
    A = _spd_csr()
    b = jnp.asarray(np.random.default_rng(1).standard_normal(256))
    M = sp.IC0Precond.from_csr(A, sweeps=3)
    x_p, info_p = sp.minres(A.to_dia(), b, M=M, tol=1e-8, max_iter=2000)
    info_p.raise_if_error()
    _, info_plain = sp.minres(A.to_dia(), b, tol=1e-8, max_iter=2000)
    info_plain.raise_if_error()
    assert int(info_p.iterations) < int(info_plain.iterations)
    r = np.asarray(A.matvec(x_p)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-6


def test_solve_api_ilu0_string():
    A = _spd_csr(dtype=np.float32)
    b = np.random.default_rng(2).standard_normal(256).astype(np.float32)
    # through plain solve(): optimize() routes the banded matrix to the
    # narrow-band DIA; M='ilu0' composes with it
    x, info = sp.solve(A, b, method="bicgstab", M="ilu0", tol=1e-8, max_iter=2000)
    r = np.asarray(A.matvec(jnp.asarray(x))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6


def test_solve_api_ic0_string():
    A = _spd_csr(dtype=np.float32)
    b = np.random.default_rng(3).standard_normal(256).astype(np.float32)
    x, info = sp.solve(A, b, method="minres", M="ic0", tol=1e-8, max_iter=2000)
    r = np.asarray(A.matvec(jnp.asarray(x))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6


def test_solve_api_ilu0_needs_matrix():
    A = _spd_csr()
    with pytest.raises(InvalidPreconditioner):
        sp.solve(A.to_dia(), np.ones(256, np.float32), M="ilu0")
