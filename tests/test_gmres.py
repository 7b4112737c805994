"""GMRES(m): convergence on nonsymmetric systems, restart semantics,
preconditioning, complex, padded-layout routing, distributed, scipy compat.

No reference counterpart (the reference's general-matrix solver is BiCGStab);
the oracle here is the true residual ‖b − A·x‖/‖b‖ computed in NumPy, plus
the m-step exactness property of full (unrestarted) GMRES.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import sprsolve_tpu as sp
from sprsolve_tpu.errors import Status
from sprsolve_tpu.utils import problems


def _convection_diffusion(nx, ny, wind=20.0):
    """Nonsymmetric upwinded convection-diffusion on an (nx, ny) grid."""
    n = nx * ny
    A = np.zeros((n, n))
    for r in range(ny):
        for c in range(nx):
            i = r * nx + c
            A[i, i] = 4.0 + wind / nx
            if c > 0:
                A[i, i - 1] = -1.0 - wind / nx  # upwind west
            if c + 1 < nx:
                A[i, i + 1] = -1.0
            if r > 0:
                A[i, i - nx] = -1.0
            if r + 1 < ny:
                A[i, i + nx] = -1.0
    return A


def _true_res(dense, x, b):
    return np.linalg.norm(dense @ np.asarray(x) - b) / np.linalg.norm(b)


def test_gmres_nonsymmetric_converges():
    dense = _convection_diffusion(12, 12)
    A = sp.csr_from_dense(dense)
    b = np.random.default_rng(0).standard_normal(144)
    x, info = sp.gmres(A, jnp.asarray(b), tol=1e-10, max_iter=500, restart=30)
    info.raise_if_error()
    assert int(info.status) == Status.CONVERGED
    assert _true_res(dense, x, b) < 1e-9


def test_gmres_full_is_exact_in_n_steps():
    """Unrestarted GMRES is a direct method: ≤ n inner steps to machine tol."""
    rng = np.random.default_rng(1)
    n = 24
    dense = np.eye(n) * 3.0 + 0.5 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    x, info = sp.gmres(
        sp.csr_from_dense(dense), jnp.asarray(b),
        tol=1e-12, max_iter=2 * n, restart=n,
    )
    info.raise_if_error()
    assert int(info.iterations) <= n
    assert _true_res(dense, x, b) < 1e-10


def test_gmres_restart_needs_more_iterations():
    """A small restart converges but in more total steps than full GMRES."""
    dense = _convection_diffusion(10, 10)
    b = np.random.default_rng(2).standard_normal(100)
    A = sp.csr_from_dense(dense)
    _, info_full = sp.gmres(A, jnp.asarray(b), tol=1e-10, max_iter=400, restart=100)
    _, info_r10 = sp.gmres(A, jnp.asarray(b), tol=1e-10, max_iter=400, restart=10)
    info_full.raise_if_error()
    info_r10.raise_if_error()
    assert int(info_r10.iterations) >= int(info_full.iterations)


def test_gmres_jacobi_precond_helps():
    dense = _convection_diffusion(12, 12, wind=40.0)
    # scale rows to make Jacobi matter
    scal = np.linspace(1.0, 50.0, 144)
    dense = dense * scal[:, None]
    A = sp.csr_from_dense(dense)
    b = np.random.default_rng(3).standard_normal(144)
    M = sp.DiagPrecond.new(jnp.asarray(np.diag(dense)))
    x_p, info_p = sp.gmres(A, jnp.asarray(b), M=M, tol=1e-10, max_iter=600, restart=25)
    x_u, info_u = sp.gmres(A, jnp.asarray(b), tol=1e-10, max_iter=600, restart=25)
    info_p.raise_if_error()
    assert _true_res(dense, x_p, b) < 1e-8
    assert int(info_p.iterations) < int(info_u.iterations)


def test_gmres_complex():
    A, rhs = problems.hermitian_grid((8, 8))
    # manufactured solution of the generator: x[vid] = row + col·i
    x_known = np.array(
        [complex(r, c) for r in range(8) for c in range(8)], np.complex128
    )
    x, info = sp.gmres(A, jnp.asarray(rhs), tol=1e-12, max_iter=300, restart=40)
    info.raise_if_error()
    np.testing.assert_allclose(np.asarray(x), x_known, atol=1e-9)


def test_gmres_insufficient_iter_status():
    dense = _convection_diffusion(12, 12)
    b = np.ones(144)
    x, info = sp.gmres(
        sp.csr_from_dense(dense), jnp.asarray(b), tol=1e-14, max_iter=5, restart=3
    )
    assert int(info.status) == Status.INSUFFICIENT_ITER
    assert int(info.iterations) == 5
    with pytest.raises(sp.errors.InsufficientIterNum):
        info.raise_if_error()


def test_gmres_zero_rhs():
    dense = _convection_diffusion(6, 6)
    x, info = sp.gmres(
        sp.csr_from_dense(dense), jnp.zeros(36), tol=1e-10, max_iter=50
    )
    assert int(info.status) == Status.CONVERGED
    assert int(info.iterations) == 0
    assert float(jnp.max(jnp.abs(x))) == 0.0


def test_gmres_record_residuals():
    dense = _convection_diffusion(8, 8)
    b = np.random.default_rng(5).standard_normal(64)
    x, info, hist = sp.gmres(
        sp.csr_from_dense(dense), jnp.asarray(b),
        tol=1e-10, max_iter=200, restart=20, record_residuals=True,
    )
    info.raise_if_error()
    k = int(info.iterations)
    h = np.asarray(hist)
    assert np.all(np.isfinite(h[:k]))
    assert np.all(np.isnan(h[k:]))
    assert h[k - 1] <= 1e-10  # last recurrence estimate is the converged one


def test_solve_api_gmres_padded_layout():
    """solve(method='gmres') through optimize(): the banded matrix lands on
    the narrow-band DIA, whose widened f32 products gmres must handle."""
    A = problems.grid_laplacian_dirichlet((16, 16))
    dense32 = np.asarray(A.todense()).astype(np.float32)
    csr = sp.csr_from_dense(dense32)
    rhs = np.zeros(256, np.float32)
    problems.set_boundary_condition(rhs, (16, 16), lambda r, c: float(r + c))
    x, info = sp.solve(csr, rhs, method="gmres", tol=1e-6, max_iter=600, restart=40)
    info.raise_if_error()
    dense = np.asarray(A.todense())
    assert _true_res(dense, x, rhs) < 1e-5
    op = sp.optimize(csr)
    # the narrow-band DIA route really was exercised
    assert isinstance(op, sp.DIA) and op.bands.dtype == np.int8


def test_gmres_object_api():
    dense = _convection_diffusion(10, 10)
    A = sp.csr_from_dense(dense)
    b = np.random.default_rng(6).standard_normal(100)
    solver = sp.GMRES.new(A, 100, restart=25)
    x, (its, res) = solver.solve(b, max_iter=400, tol=1e-10)
    assert _true_res(dense, x, b) < 1e-9
    xp, (its_p, _) = solver.precond_solve(
        sp.DiagPrecond.new(A.diagonal()), b, max_iter=400, tol=1e-10
    )
    assert _true_res(dense, xp, b) < 1e-9


def test_scipy_compat_gmres():
    scipy_sparse = pytest.importorskip("scipy.sparse")
    from scipy.sparse.linalg import gmres as scipy_gmres

    from sprsolve_tpu import scipy_compat as spc

    dense = _convection_diffusion(12, 12)
    A_sc = scipy_sparse.csr_matrix(dense)
    b = np.random.default_rng(7).standard_normal(144)
    x_ref, info_ref = scipy_gmres(A_sc, b, rtol=1e-10, restart=20)
    x, info = spc.gmres(A_sc, b, rtol=1e-10, restart=20)
    assert info == 0 and info_ref == 0
    assert _true_res(dense, x, b) < 1e-9
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-7)


def test_distributed_gmres():
    from functools import partial

    from sprsolve_tpu.parallel import distributed_solve

    A, _ = problems.sym_grid_laplacian((16, 16))
    A = sp.csr_from_dense(-np.asarray(A.todense()))
    rhs = np.random.default_rng(8).standard_normal(256)
    x, info = distributed_solve(
        partial(sp.gmres, restart=30), A.to_dia(), rhs, tol=1e-10, max_iter=600
    )
    info.raise_if_error()
    r = np.asarray(A.matvec(x)) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-8
