"""COCG (conjugate-orthogonal CG) for complex-symmetric systems — beyond
the reference's surface (its complex-symmetric solver is CS-MINRES):
oracle parity, CG reduction on real systems, complex-Jacobi
preconditioning, solve() routing, and the distributed path."""

import jax
import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.errors import Status
from sprsolve_tpu.precond import ComplexDiagPrecond as _CDP
from sprsolve_tpu.solvers import cocg
from sprsolve_tpu.utils import problems


def _x_known(rows, cols):
    return np.array([complex(i, j) for i in range(rows) for j in range(cols)])


def _problem():
    A, rhs, diag = problems.complex_symmetric_grid_with_diag((8, 8))
    return A, rhs, diag


def test_cocg_complex_symmetric_manufactured_solution():
    A, rhs, diag = _problem()
    M = _CDP.new(diag)  # complex Jacobi — valid for COCG
    x, info = cocg(A, jnp.asarray(rhs), M=M, tol=1e-13, max_iter=500)
    info.raise_if_error()
    assert np.abs(np.asarray(x) - _x_known(8, 8)).max() < 1e-10
    # unpreconditioned converges too (slower)
    x2, info2 = cocg(A, jnp.asarray(rhs), tol=1e-13, max_iter=1000)
    info2.raise_if_error()
    assert int(info.iterations) <= int(info2.iterations)
    assert np.abs(np.asarray(x2) - _x_known(8, 8)).max() < 1e-10


def test_cocg_reduces_to_cg_on_real_spd():
    """On a real SPD system the unconjugated bilinear form IS the Euclidean
    inner product: COCG must match CG step for step."""
    A = problems.poisson3d(6, 6, 6, dtype=np.float64)  # SPD
    rhs = np.random.default_rng(0).standard_normal(216)
    x1, i1 = sp.cg(A, jnp.asarray(rhs), tol=1e-12, max_iter=600)
    x2, i2 = cocg(A, jnp.asarray(rhs), tol=1e-12, max_iter=600)
    i1.raise_if_error()
    i2.raise_if_error()
    assert int(i1.iterations) == int(i2.iterations)
    np.testing.assert_allclose(
        np.asarray(x1), np.asarray(x2), rtol=1e-12, atol=1e-12
    )


def test_cocg_matches_dense_oracle_counts():
    """Left-fold dense COCG oracle: same update order, same guards —
    iteration counts must match closely on a benign system."""
    A, rhs, diag = _problem()
    dense = np.asarray(A.todense())
    Minv = 1.0 / diag

    # dense COCG oracle (numpy pairwise reductions)
    x = np.zeros(64, np.complex128)
    r = rhs - dense @ x
    z = Minv * r
    p = z.copy()
    rho = r @ z  # unconjugated
    it_oracle = None
    for it in range(500):
        if np.linalg.norm(r) <= 1e-13 * np.linalg.norm(rhs):
            it_oracle = it
            break
        q = dense @ p
        alpha = rho / (p @ q)
        x = x + alpha * p
        r = r - alpha * q
        z = Minv * r
        rho_new = r @ z
        p = z + (rho_new / rho) * p
        rho = rho_new
    assert it_oracle is not None

    M = _CDP.new(diag)
    xj, info = cocg(A, jnp.asarray(rhs), M=M, tol=1e-13, max_iter=500)
    info.raise_if_error()
    assert abs(int(info.iterations) - it_oracle) <= max(3, it_oracle // 10)


def test_cocg_through_solve_api():
    """solve(method='cocg', M='jacobi') routes through the complex DIA with
    the complex Jacobi and converges."""
    A, rhs, _ = _problem()
    x, info = sp.solve(A, rhs, method="cocg", M="jacobi", tol=1e-12,
                       max_iter=500)
    info.raise_if_error()
    assert np.abs(np.asarray(x) - _x_known(8, 8)).max() < 1e-9


def test_cocg_warm_start_and_zero_rhs():
    A, rhs, _ = _problem()
    x_exact = jnp.asarray(_x_known(8, 8))
    x, info = cocg(A, jnp.asarray(rhs), x_exact, tol=1e-10, max_iter=100)
    assert int(info.status) == Status.CONVERGED and int(info.iterations) == 0
    xz, infoz = cocg(A, jnp.zeros(64, jnp.complex128), tol=1e-10, max_iter=10)
    assert int(infoz.status) == Status.CONVERGED
    assert np.all(np.asarray(xz) == 0)


def test_cocg_residual_trace():
    A, rhs, diag = _problem()
    M = _CDP.new(diag)
    x, info, hist = cocg(
        A, jnp.asarray(rhs), M=M, tol=1e-10, max_iter=200,
        record_residuals=True,
    )
    info.raise_if_error()
    h = np.asarray(hist)
    it = int(info.iterations)
    assert np.isclose(h[0], 1.0, rtol=1e-6)  # x0 = 0 → first rel res = 1
    assert np.isfinite(h[: it + 1]).all()
    assert np.isnan(h[it + 1:]).all()


def test_cocg_distributed():
    """COCG over the 8-device mesh with c64 bands in a HaloDIA and the
    distributed complex Jacobi."""
    from sprsolve_tpu.parallel import distributed_solve

    A, rhs, _ = problems.complex_symmetric_grid_with_diag(
        (16, 16), dtype=np.complex64
    )
    mesh = jax.make_mesh((8,), ("rows",), devices=jax.devices()[:8])
    dense = np.asarray(A.todense())
    x, info = distributed_solve(
        cocg, A.to_dia(), jnp.asarray(rhs.astype(np.complex64)),
        M=_CDP.new(np.asarray(dense.diagonal())), tol=1e-5, max_iter=500,
        mesh=mesh,
    )
    info.raise_if_error()
    r = dense @ np.asarray(x) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-4


def test_refine_complex_with_cocg_inner():
    """c128 refinement with COCG inner solves (the cheapest complex inner:
    one SpMV per inner iteration)."""
    A, rhs, _ = _problem()
    x, info = sp.refine_solve(A, rhs, inner="cocg", M="jacobi", tol=1e-12)
    info.raise_if_error()
    dense = np.asarray(A.todense())
    r = dense @ np.asarray(x) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-11


def test_vmapped_columns_freeze_at_own_convergence():
    """Round-5 regression: under vmap the while_loop body runs until the
    SLOWEST column finishes, and COCG's non-minimizing recurrence wanders
    after convergence — an un-frozen early-converged column came back as
    garbage (found by the rational filter's batched inner solves).  Each
    column must stop at its own exit with its reported residual equal to
    the true residual of the returned iterate."""
    import dataclasses

    from sprsolve_tpu.solvers.rational import _ComplexShifted
    from sprsolve_tpu.utils import problems

    A, _ = problems.sym_grid_laplacian((32, 32))
    A = dataclasses.replace(A, data=-A.data)
    A32 = dataclasses.replace(
        A, data=np.asarray(A.data).astype(np.float32)
    ).to_dia()
    n = 1024
    opz = _ComplexShifted(
        A=A32, zr=jnp.float32(2.0), zi=jnp.float32(3e-4)
    )
    rng = np.random.default_rng(0)
    Y = (rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
         ).astype(np.complex64)
    # column 0 trivial: rhs manufactured from a known solution, so it
    # converges in O(100) iterations while the others need ~1000
    e = rng.standard_normal(n).astype(np.float32)
    Y[:, 0] = np.asarray(opz.matvec(jnp.asarray(e, jnp.complex64)))
    Yj = jnp.asarray(Y)

    solve = lambda y: sp.cocg(opz, y, tol=1e-2, max_iter=3000)
    X, infos = jax.vmap(solve, in_axes=1, out_axes=(1, 0))(Yj)

    its = np.asarray(infos.iterations)
    assert its[0] < its[1:].min() / 2, its  # col 0 genuinely froze early
    for c in range(4):
        r = np.asarray(opz.matvec(X[:, c])) - Y[:, c]
        tr = np.linalg.norm(r) / np.linalg.norm(Y[:, c])
        assert tr <= 1.1e-2, (c, tr)
        # reported == true residual of the returned (frozen) iterate
        np.testing.assert_allclose(
            float(infos.residual[c]), tr, rtol=1e-2
        )
