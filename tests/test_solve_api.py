"""Top-level solve() convenience: layout auto-selection + padding handled."""


import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.utils import problems


def test_solve_auto_layout_stencil():
    A = problems.grid_laplacian_dirichlet((16, 16))
    b = np.zeros(256)
    problems.set_boundary_condition(b, (16, 16), lambda r, c: float(r + c))
    x, info = sp.solve(A, b, method="bicgstab", M="jacobi", tol=1e-13, max_iter=1500)
    info.raise_if_error()
    assert x.shape == (256,)
    r = np.asarray(A.matvec(x)) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_solve_minres_and_explicit_precond():
    A, rhs, diag = problems.hermitian_grid_with_diag((8, 8))
    x, info = sp.solve(
        A, rhs, method="minres", M=sp.DiagPrecond.new(diag), tol=1e-22, max_iter=300
    )
    info.raise_if_error()
    xk = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(x) - xk).max() < 1e-12


def test_solve_cs_minres_auto():
    A, rhs, _ = problems.complex_symmetric_grid_with_diag((8, 8))
    x, info = sp.solve(A, rhs, method="cs_minres", tol=1e-22, max_iter=300)
    info.raise_if_error()
    xk = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(x) - xk).max() < 1e-12


def test_solve_general_matrix_without_optimize():
    import scipy.sparse as sps

    S = sps.random(150, 150, density=0.05, random_state=0, format="csr") + sps.eye(150) * 8
    A = sp.csr_from_scipy(S)
    b = np.ones(150)
    x, info = sp.solve(A, b, tol=1e-11, max_iter=500)
    info.raise_if_error()
    assert np.linalg.norm(S @ np.asarray(x) - b) < 1e-8


def test_solve_accepts_csc_with_jacobi():
    from sprsolve_tpu import CSC

    indptr = np.array([0, 1, 2, 3])
    indices = np.array([0, 1, 2])
    data = np.array([4.0, 5.0, 6.0])
    A = CSC.from_arrays(data, indices, indptr, (3, 3))
    x, info = sp.solve(A, np.array([4.0, 10.0, 18.0]), M="jacobi", tol=1e-14, max_iter=50)
    info.raise_if_error()
    np.testing.assert_allclose(np.asarray(x), [1.0, 2.0, 3.0], rtol=1e-12)

def test_solve_cs_minres_accepts_jacobi():
    """method='cs_minres' with M='jacobi' routes through the real 1/|d|
    Jacobi (the preconditioned Saunders form added beyond the reference —
    the reference's CSMinRes exports only solve, src/cs_minres.rs) and the
    solve converges. An invalid (non-positive) M is caught at runtime by
    the β² gate rather than rejected up front."""
    from sprsolve_tpu.errors import Status

    A, rhs, diag = problems.complex_symmetric_grid_with_diag((8, 8))
    x, info = sp.solve(A, rhs, method="cs_minres", M="jacobi", tol=1e-12,
                       max_iter=300)
    info.raise_if_error()
    dense = np.asarray(A.todense())
    r = dense @ np.asarray(x) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-10

    # a negative-definite "preconditioner" trips the β² > 0 gate
    x2, info2 = sp.solve(
        A, rhs, method="cs_minres",
        M=sp.DiagPrecond.new(-np.ones(64)), tol=1e-12, max_iter=300,
    )
    assert int(info2.status) == Status.INVALID_PRECONDITIONER


def test_solve_complex_padded_jacobi():
    """M='jacobi' on the c64 DIA path builds the complex diagonal
    preconditioner (previously silently dropped)."""
    A, rhs, _ = problems.complex_symmetric_grid_with_diag((8, 8), dtype=np.complex64)
    x_mj, info_mj = sp.solve(A, rhs, method="bicgstab", M="jacobi", tol=1e-5, max_iter=300)
    info_mj.raise_if_error()
    x_un, info_un = sp.solve(A, rhs, method="bicgstab", tol=1e-5, max_iter=300)
    info_un.raise_if_error()
    xk = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(x_mj) - xk).max() < 1e-2
    # the preconditioner must actually act: iteration counts differ
    assert int(info_mj.iterations) != int(info_un.iterations)


def test_solve_complex_padded_warm_start():
    """x0 threads through the complex solve (previously ignored)."""
    A, rhs, _ = problems.complex_symmetric_grid_with_diag((8, 8), dtype=np.complex64)
    xk = np.array([complex(i, j) for i in range(8) for j in range(8)], dtype=np.complex64)
    x, info = sp.solve(A, rhs, method="bicgstab", x0=xk, tol=1e-4, max_iter=300)
    info.raise_if_error()
    assert int(info.iterations) == 0  # already converged at the warm start


def test_prepare_reuses_layout_across_rhs():
    """prepare(): optimize + precond-build + jit once, many rhs; warm start."""
    import numpy as np
    from sprsolve_tpu.utils import problems

    A, _ = problems.sym_grid_laplacian((16, 16))
    dense = -np.asarray(A.todense()).astype(np.float32)
    Af = sp.csr_from_dense(dense)
    handle = sp.prepare(Af, method="cg", M="ic0", tol=1e-6, max_iter=1000)
    rng = np.random.default_rng(0)
    for trial in range(3):
        b = rng.standard_normal(256).astype(np.float32)
        x, info = handle(b)
        r = dense @ np.asarray(x) - b
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4, trial
    # warm start: re-solving from the solution converges immediately
    x2, info2 = handle(b, x0=x)
    assert int(info2.iterations) <= 1
    # dimension check still enforced per call
    import pytest
    from sprsolve_tpu.errors import IncompatibleMatrixFormat

    with pytest.raises(IncompatibleMatrixFormat):
        handle(np.ones(13, np.float32))


def test_prepare_complex_padded_planes():
    """prepare() on a complex system whose layout optimizes to the c64 DIA
    operator: complex vectors cross the jit boundary as they are;
    re-solves and warm starts work like the real path."""
    A, rhs, _diag = problems.complex_symmetric_grid_with_diag((8, 8))
    A32 = sp.CSR.from_arrays(
        np.asarray(A.data, np.complex64), A.indices, A.indptr, A.shape
    )
    handle = sp.prepare(A32, method="cs_minres", tol=1e-6, max_iter=500)
    assert isinstance(handle.operator, sp.DIA)
    assert handle.operator.dtype == jnp.complex64
    b = np.asarray(rhs, np.complex64)
    x1, info1 = handle(b)
    info1.raise_if_error()
    r = np.asarray(A32.matvec(jnp.asarray(x1))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4
    # second rhs, warm-started from the first solution
    x2, info2 = handle(b * (0.5 + 0.25j), x0=x1 * (0.5 + 0.25j))
    info2.raise_if_error()
    assert int(info2.iterations) <= 2


def test_auto_method_structure_dispatch():
    """method='auto': Hermitian/real-symmetric -> minres, complex
    symmetric -> cocg, nonsymmetric -> bicgstabl (the measured-fastest
    robust path; parity='reference' keeps plain bicgstab), rectangular ->
    lsqr, operators (uninspectable) -> bicgstabl."""
    from sprsolve_tpu.api import _auto_method

    Asym = problems.poisson3d(6, 6, 6, dtype=np.float64)
    assert _auto_method(Asym) == "minres"
    Aherm, _ = problems.hermitian_grid((6, 6))
    assert _auto_method(Aherm) == "minres"
    Acs, _, _ = problems.complex_symmetric_grid_with_diag((6, 6))
    assert _auto_method(Acs) == "cocg"
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.2)
    dense += np.eye(40) * 5
    Ansym = sp.csr_from_dense(dense)
    assert _auto_method(Ansym) == "bicgstabl"
    assert _auto_method(Ansym, parity="reference") == "bicgstab"
    assert _auto_method(sp.csr_from_dense(rng.standard_normal((30, 12)))) == "lsqr"
    assert _auto_method(Asym.to_dia()) == "bicgstabl"  # operator: no inspection
    assert _auto_method(Asym.to_dia(), parity="reference") == "bicgstab"


def test_solve_auto_nonsymmetric_routes_fast_path():
    # auto on a nonsymmetric system runs BiCGStab(2) by default and
    # converges; parity="reference" runs plain BiCGStab (VERDICT r3 #6)
    rng = np.random.default_rng(7)
    dense = rng.standard_normal((60, 60)) * (rng.random((60, 60)) < 0.15)
    dense += np.eye(60) * 8
    A = sp.csr_from_dense(dense)
    b = rng.standard_normal(60)
    x, info = sp.solve(A, b, method="auto", tol=1e-9, max_iter=300)
    info.raise_if_error()
    r = dense @ np.asarray(x) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8
    xr, infor = sp.solve(A, b, method="auto", parity="reference", tol=1e-9,
                         max_iter=300)
    infor.raise_if_error()
    rr = dense @ np.asarray(xr) - b
    assert np.linalg.norm(rr) / np.linalg.norm(b) < 1e-8


def test_solve_method_auto_end_to_end():
    # symmetric -> minres path converges
    A = problems.poisson3d(6, 6, 6, dtype=np.float64)
    b = np.random.default_rng(1).standard_normal(216)
    x, info = sp.solve(A, b, method="auto", tol=1e-11, max_iter=600)
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10
    # complex symmetric -> cocg path converges to the manufactured solution
    Ac, bc, _ = problems.complex_symmetric_grid_with_diag((8, 8))
    xc, infoc = sp.solve(Ac, bc, method="auto", M="jacobi", tol=1e-12,
                         max_iter=600)
    infoc.raise_if_error()
    want = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(xc) - want).max() < 1e-9
    # prepare() accepts auto too
    h = sp.prepare(A, method="auto", tol=1e-10, max_iter=600)
    x2, info2 = h(b)
    info2.raise_if_error()
