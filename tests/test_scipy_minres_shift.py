"""ShiftedOperator and scipy_compat.minres shift support."""

import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu import scipy_compat
from sprsolve_tpu.utils import problems


def _spd():
    A, _ = problems.sym_grid_laplacian((12, 12))
    dense = -np.asarray(A.todense())
    return sp.csr_from_dense(dense), dense


def test_shifted_operator_matvec_and_diag():
    A, dense = _spd()
    S = sp.ShiftedOperator(A=A, shift=jnp.asarray(0.75))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(144))
    np.testing.assert_allclose(
        np.asarray(S.matvec(x)), dense @ np.asarray(x) - 0.75 * np.asarray(x),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(S.diagonal()), np.diag(dense) - 0.75, atol=1e-14
    )
    X = jnp.asarray(np.random.default_rng(1).standard_normal((144, 3)))
    np.testing.assert_allclose(
        np.asarray(S.matmat(X)),
        dense @ np.asarray(X) - 0.75 * np.asarray(X), atol=1e-12,
    )


def test_minres_shift_matches_dense():
    A, dense = _spd()
    b = np.random.default_rng(2).standard_normal(144)
    shift = 0.3  # below lambda_min keeps A - shift*I definite-ish; MINRES
    # handles indefinite anyway
    x, info = scipy_compat.minres(A, b, shift=shift, rtol=1e-12, maxiter=2000)
    assert info == 0
    want = np.linalg.solve(dense - shift * np.eye(144), b)
    np.testing.assert_allclose(np.asarray(x), want, atol=1e-7)


def test_shifted_solve_through_api():
    A, dense = _spd()
    S = sp.ShiftedOperator(A=A.to_dia(), shift=jnp.asarray(-1.0))
    b = jnp.asarray(np.random.default_rng(3).standard_normal(144))
    x, info = sp.minres(S, b, tol=1e-12, max_iter=2000)
    info.raise_if_error()
    want = np.linalg.solve(dense + np.eye(144), np.asarray(b))
    np.testing.assert_allclose(np.asarray(x), want, atol=1e-8)


def test_shifted_padded_operator_jacobi():
    """solve(ShiftedOperator(Reordered DIA), M='jacobi') — the shifted
    Jacobi 1/(diag − σ) is re-laid into the operator's permuted layout."""
    from sprsolve_tpu.ops.reordered import Reordered
    from sprsolve_tpu.sparse.containers import reorder_rcm

    A, dense = _spd()
    Ap, perm = reorder_rcm(sp.CSR.from_arrays(
        np.asarray(A.data, np.float32), A.indices, A.indptr, A.shape
    ))
    p = Reordered.wrap(sp.DIA.from_csr(Ap, max_diags=512), perm)
    S = sp.ShiftedOperator(A=p, shift=jnp.asarray(-1.0, jnp.float32))
    b = np.random.default_rng(5).standard_normal(144).astype(np.float32)
    x, info = sp.solve(S, b, method="minres", M="jacobi", tol=1e-5,
                       max_iter=2000, optimize_layout=False)
    info.raise_if_error()
    want = np.linalg.solve(dense + np.eye(144), b)
    np.testing.assert_allclose(np.asarray(x), want, atol=1e-3)
    # diagonal() of the shifted padded operator is flat and shifted
    np.testing.assert_allclose(
        np.asarray(S.diagonal()), np.diag(dense).astype(np.float32) + 1.0,
        rtol=1e-6,
    )


def test_scipy_minres_shift_keeps_kernel_layout():
    from sprsolve_tpu.ops.operator import ShiftedOperator

    A, dense = _spd()
    # reach into the wrapper solve() receives: shift should wrap the
    # *optimized* operator, not the raw CSR
    from sprsolve_tpu import scipy_compat as sc

    op = sc.aslinearoperator(A)
    from sprsolve_tpu.ops.optimize import optimize

    opt = optimize(op)
    assert hasattr(opt, "pad_vec") or type(opt).__name__ != "CSR"
    x, code = sc.minres(A, np.random.default_rng(6).standard_normal(144),
                        shift=0.25, rtol=1e-10, maxiter=3000)
    assert code == 0
