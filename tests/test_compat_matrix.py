"""Solver × preconditioner × dtype compatibility matrix.

A systematic sweep over the public `solve()` surface on appropriately
structured small systems: every (method, M) cell must either converge to a
direct-solver-verified solution or raise a *typed* error documented for
that combination — never return garbage, never crash with an anonymous
exception.  This is the wiring-regression net over the whole surface; the
per-solver algorithmic tests live in their own files.

The method lists are DERIVED from ``api._SOLVERS`` (the registry that
defines what ``solve()`` can reach): each method is classified into a
fixture class below, and ``test_solver_registry_fully_classified`` fails
the moment a new method lands in the registry without a matrix cell —
the drift that left the s-step pair outside the net in round 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla

import sprsolve_tpu as sp
from sprsolve_tpu import errors
from sprsolve_tpu.api import _SOLVERS

# fixture classes (structure each method requires); membership is checked
# against the registry below so nothing can drift out of the net
_SPD = ["cg", "cg_single_sync", "ca_cg", "minres"]
_COMPLEX_SYM = ["cocg", "cs_minres"]
_NORMAL_EQ = ["lsqr"]
_GENERAL = sorted(
    m for m in _SOLVERS if m not in _SPD + _COMPLEX_SYM + _NORMAL_EQ
)
_PRECONDS = [None, "jacobi", "block_jacobi", "ilu0", "amg"]
_SPD_PRECONDS = [None, "jacobi", "block_jacobi", "ic0", "amg"]

# documented-invalid cells: must raise InvalidPreconditioner BEFORE any
# garbage solve (the s-step basis is a polynomial in the bare operator;
# only ca_cg+jacobi folds, see solvers/ca_cg.py::fold_jacobi)
_TYPED_REJECT = {
    ("ca_bicgstab", M) for M in _PRECONDS if M is not None
} | {
    ("ca_cg", M) for M in _SPD_PRECONDS if M not in (None, "jacobi")
} | {
    ("lsqr", M) for M in _PRECONDS if M is not None
}


def test_solver_registry_fully_classified():
    """Every solve()-reachable method sits in exactly one fixture class."""
    classes = [_GENERAL, _SPD, _COMPLEX_SYM, _NORMAL_EQ]
    union = set().union(*classes)
    assert union == set(_SOLVERS), (
        f"unclassified solve() methods: {set(_SOLVERS) - union} — add them "
        "to a fixture class in this file"
    )
    assert sum(len(c) for c in classes) == len(union), "a method is in two classes"


def _diag_dominant(n=140, seed=0, density=0.04):
    A = sps.random(n, n, density=density, random_state=seed)
    A = A + sps.diags(np.abs(A).sum(axis=1).A1 + 1.0)
    return A.tocsr()


def _spd(n=140, seed=0):
    A = sps.random(n, n, density=0.04, random_state=seed)
    A = A @ A.T + sps.eye(n) * 4.0
    return A.tocsr()


def _check(S, method, M, tol=1e-10):
    A = sp.csr_from_scipy(S)
    b = np.random.default_rng(42).standard_normal(S.shape[0])
    if (method, M) in _TYPED_REJECT:
        with pytest.raises(errors.InvalidPreconditioner):
            sp.solve(A, b, method=method, M=M, tol=tol, max_iter=4000)
        return
    x_direct = spla.spsolve(S.tocsc(), b)
    x, info = sp.solve(A, b, method=method, M=M, tol=tol, max_iter=4000)
    info.raise_if_error()
    np.testing.assert_allclose(
        np.asarray(x), x_direct, rtol=1e-5, atol=1e-7,
        err_msg=f"{method} + {M}",
    )


@pytest.mark.parametrize("M", _PRECONDS)
@pytest.mark.parametrize("method", _GENERAL)
def test_general_matrix_cells(method, M):
    _check(_diag_dominant(), method, M)


@pytest.mark.parametrize("M", _SPD_PRECONDS)
@pytest.mark.parametrize("method", _SPD)
def test_spd_cells(method, M):
    # symmetric preconditioners only: CG/MINRES require a symmetric-
    # positive M (ilu0 is the nonsymmetric factorization — see
    # test_spd_with_nonsymmetric_M_fails_cleanly)
    _check(_spd(), method, M)


@pytest.mark.parametrize("M", [None, "jacobi"])
@pytest.mark.parametrize("method", _NORMAL_EQ)
def test_normal_eq_cells(method, M):
    # lsqr runs on the square fixture too (rectangular has its own file);
    # its preconditioned form is deliberately unsupported → typed reject
    _check(_diag_dominant(), method, M)


@pytest.mark.parametrize("method", [m for m in _SPD if m != "ca_cg"])
def test_spd_with_nonsymmetric_M_fails_cleanly(method):
    """ilu0 on an SPD system is a *user error* (nonsymmetric M breaks the
    CG/MINRES invariants).  The cell must fail with a TYPED error — MINRES
    detects it at the β² gate (InvalidPreconditioner), CG stagnates to
    InsufficientIterNum — never return garbage labeled CONVERGED.
    (ca_cg rejects ilu0 up front — covered by _TYPED_REJECT above.)"""
    S = _spd()
    A = sp.csr_from_scipy(S)
    b = np.random.default_rng(42).standard_normal(S.shape[0])
    with pytest.raises(errors.SolverError):
        x, info = sp.solve(A, b, method=method, M="ilu0", tol=1e-10,
                           max_iter=800)
        info.raise_if_error()


@pytest.mark.parametrize("M", [None, "jacobi"])
@pytest.mark.parametrize("method", _COMPLEX_SYM)
def test_complex_symmetric_cells(method, M):
    _complex_sym_cell(method, M)


def test_ca_bicgstab_complex_cell():
    """The s-step nonsymmetric solver also serves complex systems through
    solve() (Gershgorin-default basis; no M — covered by _TYPED_REJECT)."""
    _complex_sym_cell("ca_bicgstab", None, tol=1e-10, bound=1e-8)


def _complex_sym_cell(method, M, tol=1e-12, bound=1e-9):
    from sprsolve_tpu.utils import problems

    A, rhs, _d = problems.complex_symmetric_grid_with_diag((8, 8))
    x_known = np.array([complex(i, j) for i in range(8) for j in range(8)])
    x, info = sp.solve(A, rhs, method=method, M=M, tol=tol,
                       max_iter=2000)
    info.raise_if_error()
    assert np.abs(np.asarray(x) - x_known).max() < bound


@pytest.mark.parametrize("method", sorted(_SOLVERS))
def test_f32_cells(method):
    """Every method also runs in f32 end to end."""
    if method in _COMPLEX_SYM:
        from sprsolve_tpu.utils import problems

        A64, rhs, _d = problems.complex_symmetric_grid_with_diag((8, 8))
        S = sps.csr_matrix(
            (np.asarray(A64.data), np.asarray(A64.indices),
             np.asarray(A64.indptr)), shape=A64.shape,
        ).astype(np.complex64)
        b = np.asarray(rhs).astype(np.complex64)
    else:
        S = (_spd() if method in _SPD else _diag_dominant()).astype(
            np.float32
        )
        b = np.random.default_rng(1).standard_normal(S.shape[0]).astype(
            np.float32
        )
    A = sp.csr_from_scipy(S)
    M = None if method in ("ca_bicgstab", "lsqr") else "jacobi"
    x, info = sp.solve(A, b, method=method, M=M, tol=1e-5, max_iter=4000)
    info.raise_if_error()
    r = S @ np.asarray(x) - b
    # IDR(s)'s recurrence residual drifts from the true residual in f32
    # (~10x at this conditioning), but its outer true-residual restart
    # re-anchors the recurrence, so every method holds the same bound
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4


def test_invalid_cells_raise_typed_errors():
    """Documented-invalid combinations reject cleanly before the solve."""
    from sprsolve_tpu.utils import problems

    A, rhs, _d = problems.complex_symmetric_grid_with_diag((8, 8))
    # cs_minres demands a real symmetric-positive M: the complex Jacobi
    # string path builds 1/|d| (valid), but an explicit complex M rejects
    from sprsolve_tpu.precond import ComplexDiagPrecond

    M = ComplexDiagPrecond.new(_d)
    with pytest.raises(errors.InvalidPreconditioner):
        sp.solve(A, rhs, method="cs_minres", M=M, tol=1e-8, max_iter=50)
    # unknown method name
    with pytest.raises(KeyError):
        sp.solve(A, rhs, method="nope", tol=1e-8, max_iter=50)
