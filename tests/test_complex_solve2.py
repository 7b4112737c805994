"""Complex-*symmetric* (non-Hermitian) solves — port of
``tests/test_complex_solve2.rs`` (preconditioned BiCGStab with a complex
diagonal), plus the CS-MINRES coverage the reference never activated
(``tests/test_minres.rs:14-15`` has it commented out)."""

import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.utils import problems

GOLDEN = {
    "precond_bicgstab_complex_2": 40,
    "cs_minres": 77,
    "cs_minres_real_sym": 34,
}


def _x_known(rows, cols):
    return np.array([complex(i, j) for i in range(rows) for j in range(cols)])


def _problem():
    A, rhs, diag = problems.complex_symmetric_grid_with_diag((8, 8))
    dense = np.asarray(A.todense())
    np.testing.assert_array_equal(dense, dense.T)  # symmetric, NOT Hermitian
    assert np.abs(dense - dense.conj().T).max() > 1.0
    return A, rhs, diag


def test_bicgstab_complex_2():
    # tests/test_complex_solve2.rs:5-28
    A, rhs, diag = _problem()
    P = sp.DiagPrecond.new(diag)
    x, (iters, res) = sp.BiCGStab.new(A, 64).precond_solve(
        P, rhs, max_iter=300, tol=1e-22
    )
    assert res <= 1e-22
    assert iters == GOLDEN["precond_bicgstab_complex_2"]
    assert np.abs(np.asarray(x) - _x_known(8, 8)).max() < 1e-12


def test_cs_minres_complex_symmetric():
    # NEW coverage: the reference exports CSMinRes but never tests it.
    A, rhs, _ = _problem()
    x, (iters, res) = sp.CSMinRes.new(A, 64).solve(rhs, max_iter=300, tol=1e-22)
    assert res < 1e-22
    assert iters == GOLDEN["cs_minres"]
    assert np.abs(np.asarray(x) - _x_known(8, 8)).max() < 1e-12


def test_cs_minres_reduces_to_minres_on_real_symmetric():
    # On a real symmetric system conj() is the identity, so the Saunders
    # process must match the Lanczos process step for step.
    A, rhs = problems.sym_grid_laplacian((8, 8))
    x1, (it1, res1) = sp.MinRes.new(A, 64).solve(rhs, max_iter=300, tol=1e-22)
    x2, (it2, res2) = sp.CSMinRes.new(A, 64).solve(rhs, max_iter=300, tol=1e-22)
    assert it1 == it2 == GOLDEN["cs_minres_real_sym"]
    assert res1 == res2
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


def test_cs_minres_preconditioned_real_jacobi():
    """Preconditioned CS-MINRES (beyond the reference — the Saunders
    adaptation of src/minres.rs:178-341): a real 1/|d| Jacobi must keep the
    manufactured solution exact and not increase the iteration count."""
    import jax.numpy as jnp

    from sprsolve_tpu.solvers import cs_minres

    A, rhs, diag = _problem()
    M = sp.DiagPrecond.new(np.abs(diag))
    x, info = cs_minres(A, jnp.asarray(rhs), M=M, max_iter=300, tol=1e-22)
    info.raise_if_error()
    assert float(info.residual) <= 1e-22
    assert int(info.iterations) <= GOLDEN["cs_minres"]
    assert np.abs(np.asarray(x) - _x_known(8, 8)).max() < 1e-12


def test_cs_minres_precond_identity_matches_unpreconditioned():
    """M = identity-scaled Jacobi must reproduce the unpreconditioned
    Saunders process bitwise (the M=I reduction of the derivation)."""
    import jax.numpy as jnp

    from sprsolve_tpu.solvers import cs_minres

    A, rhs, _ = _problem()
    M = sp.DiagPrecond.new(np.ones(64))
    x1, i1 = cs_minres(A, jnp.asarray(rhs), max_iter=300, tol=1e-22)
    x2, i2 = cs_minres(A, jnp.asarray(rhs), M=M, max_iter=300, tol=1e-22)
    assert int(i1.iterations) == int(i2.iterations)
    np.testing.assert_allclose(
        np.asarray(x1), np.asarray(x2), rtol=1e-12, atol=1e-13
    )


def test_cs_minres_invalid_precond_gate():
    """A non-positive 'preconditioner' must trip the β² > 0 gate with
    Status.INVALID_PRECONDITIONER (the src/minres.rs:235-244 analog)."""
    import jax.numpy as jnp

    from sprsolve_tpu.errors import Status
    from sprsolve_tpu.solvers import cs_minres

    A, rhs, _ = _problem()
    M = sp.DiagPrecond.new(-np.ones(64))  # negative definite: invalid
    x, info = cs_minres(A, jnp.asarray(rhs), M=M, max_iter=300, tol=1e-22)
    assert int(info.status) == Status.INVALID_PRECONDITIONER


def test_solve_api_cs_minres_jacobi():
    """solve(method='cs_minres', M='jacobi') builds the real |d| Jacobi and
    converges (previously this raised InvalidPreconditioner)."""
    from sprsolve_tpu.api import solve

    A, rhs, _ = _problem()
    x, info = solve(A, rhs, method="cs_minres", M="jacobi", tol=1e-12,
                    max_iter=300)
    info.raise_if_error()
    assert np.abs(np.asarray(x) - _x_known(8, 8)).max() < 1e-9


def test_cs_minres_precond_residual_is_trustworthy_when_M_is_illconditioned():
    """Review regression: with a wildly-scaled diagonal the old hybrid
    tracking (2-norm init contracted by M-norm sines) reported CONVERGED at
    residuals ~sqrt(κ(M)) above tolerance. The M⁻¹-norm recurrence must
    produce an actually-converged solution whenever it reports CONVERGED."""
    import jax.numpy as jnp

    from sprsolve_tpu.errors import Status
    from sprsolve_tpu.solvers import cs_minres

    n = 200
    rng = np.random.default_rng(0)
    scale = np.logspace(-4, 4, n)
    dense = np.diag(scale * (3.0 + 0.5j))
    for k in (1, 2):
        off = (0.2 + 0.1j) * np.sqrt(scale[k:] * scale[:-k])
        dense += np.diag(off, k) + np.diag(off, -k)  # complex symmetric
    import scipy.sparse as sps

    A = sp.csr_from_scipy(sps.csr_matrix(dense))
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = dense @ x_true
    M = sp.DiagPrecond.new(np.abs(np.diag(dense)))
    x, info = cs_minres(A, jnp.asarray(b), M=M, tol=1e-8, max_iter=2000)
    assert int(info.status) == Status.CONVERGED
    true_rel = np.linalg.norm(dense @ np.asarray(x) - b) / np.linalg.norm(b)
    # the M⁻¹-norm criterion may differ from the 2-norm by bounded factors,
    # but must never be orders of magnitude optimistic (the old bug was 69×)
    assert true_rel < 1e-6, true_rel


def test_cs_minres_precond_gate_is_scale_free():
    """Review regression: a tiny-magnitude rhs (β² below absolute machine
    eps) must NOT be rejected as INVALID_PRECONDITIONER."""
    import jax.numpy as jnp

    from sprsolve_tpu.solvers import cs_minres

    A, rhs, diag = problems.complex_symmetric_grid_with_diag(
        (8, 8), dtype=np.complex64
    )
    M = sp.DiagPrecond.new(np.abs(diag).astype(np.float32))
    tiny_rhs = (rhs * 1e-6).astype(np.complex64)
    x, info = cs_minres(A, jnp.asarray(tiny_rhs), M=M, tol=1e-5, max_iter=300)
    info.raise_if_error()
    dense = np.asarray(A.todense())
    r = dense @ np.asarray(x) - tiny_rhs
    assert np.linalg.norm(r) / np.linalg.norm(tiny_rhs) < 1e-4


def test_solve_cs_minres_jacobi_reordered_padded():
    """Review regression: M='jacobi' for cs_minres on a matrix that is
    banded only after RCM (optimize() → Reordered(ComplexPaddedDIA)) used
    to crash in the diagonal lookup; the shared real_abs_jacobi dispatcher
    must build the padded-layout |d| Jacobi."""
    import scipy.sparse as sps

    rng = np.random.default_rng(5)
    n = 240
    base = sps.diags(
        [np.full(n - 3, 0.5 + 0.25j), np.full(n, 9.0 + 3.0j),
         np.full(n - 3, 0.5 + 0.25j)],
        [-3, 0, 3], format="csr",
    )
    p = rng.permutation(n)
    P = sps.eye(n, format="csr")[p]
    S = (P @ base @ P.T).tocsr()  # complex symmetric under symmetric perm
    A = sp.csr_from_scipy(S.astype(np.complex64))
    x_true = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    b = S.astype(np.complex64) @ x_true
    x, info = sp.solve(A, b, method="cs_minres", M="jacobi", tol=1e-5,
                       max_iter=600)
    info.raise_if_error()
    r = S @ np.asarray(x) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4


def test_solve_cs_minres_rejects_invalid_M_classes():
    """Complex-diagonal Jacobi and triangular-sweep applies are not valid
    Saunders preconditioners — rejected up front."""
    import pytest

    from sprsolve_tpu.errors import InvalidPreconditioner

    A, rhs, diag = problems.complex_symmetric_grid_with_diag((8, 8))
    with pytest.raises(InvalidPreconditioner):
        sp.solve(A, rhs, method="cs_minres", M=sp.DiagPrecond.new(diag),
                 tol=1e-8, max_iter=100)
    with pytest.raises(InvalidPreconditioner):
        sp.solve(A, rhs, method="cs_minres", M="ilu0", tol=1e-8, max_iter=100)


def test_cs_minres_warm_start_at_solution():
    """Warm start at the exact solution: β₁ = 0 must exit CONVERGED at 0
    iterations (review regression: previously 1/0 → NaN spin to max_iter),
    both unpreconditioned and preconditioned."""
    import jax.numpy as jnp

    from sprsolve_tpu.errors import Status
    from sprsolve_tpu.solvers import cs_minres

    A, rhs, diag = _problem()
    x_exact = _x_known(8, 8)
    x1, i1 = cs_minres(A, jnp.asarray(rhs), jnp.asarray(x_exact),
                       tol=1e-10, max_iter=100)
    assert int(i1.status) == Status.CONVERGED and int(i1.iterations) == 0
    assert np.all(np.isfinite(np.asarray(x1)))
    M = sp.DiagPrecond.new(np.abs(diag))
    x2, i2 = cs_minres(A, jnp.asarray(rhs), jnp.asarray(x_exact), M=M,
                       tol=1e-10, max_iter=100)
    assert int(i2.status) == Status.CONVERGED and int(i2.iterations) == 0
    assert np.all(np.isfinite(np.asarray(x2)))


def test_solve_cs_minres_rejects_block_jacobi_string():
    """Review regression: M='block_jacobi' built complex blocks and slipped
    past the class gate; the string gate must fire before the builder."""
    import pytest

    from sprsolve_tpu.errors import InvalidPreconditioner

    A, rhs, _ = _problem()
    with pytest.raises(InvalidPreconditioner):
        sp.solve(A, rhs, method="cs_minres", M="block_jacobi", tol=1e-8,
                 max_iter=100)


def test_solve_cs_minres_jacobi_on_real_banded():
    """Review regression: a REAL banded matrix (optimize → narrow-band DIA)
    once crashed real_abs_jacobi; a real symmetric system is trivially
    complex-symmetric, so cs_minres+jacobi must work on it."""
    from sprsolve_tpu.utils import problems as _p

    from sprsolve_tpu.precond import real_abs_jacobi

    A = _p.grid_laplacian_dirichlet((16, 16), dtype=np.float32)
    op = sp.optimize(A)
    M = real_abs_jacobi(op)
    assert M.diag_inv.shape == (256,) and M.diag_inv.dtype == np.float32

    rhs = np.zeros(256, dtype=np.float32)
    _p.set_boundary_condition(rhs, (16, 16), lambda r, c: float(r + c))
    x, info = sp.solve(A, rhs, method="cs_minres", M="jacobi", tol=1e-4,
                       max_iter=800)
    info.raise_if_error()
    r = np.asarray(A.matvec(np.asarray(x))) - rhs
    # f32 recurrence estimate drifts from the true 2-norm over hundreds of
    # iterations (documented MINRES-family behavior); sanity bound only —
    # the crash regression above is the binding assertion
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 5e-3


def test_cs_minres_indefinite_M_never_reports_false_convergence():
    """Third-review regression: an indefinite 'preconditioner' with a warm
    start near the solution must never return CONVERGED with residual 0.0.
    In f64 the significant-negative β² gate flags INVALID_PRECONDITIONER;
    at any precision the conservative |β²|^½ residual estimate keeps the
    early-converged exit from firing on clamped-negative β²."""
    import jax.numpy as jnp

    from sprsolve_tpu.errors import Status
    from sprsolve_tpu.solvers import cs_minres

    n = 100
    A = sp.csr_from_dense(np.eye(n, dtype=np.complex128))
    dinv = np.ones(n)
    dinv[0] = -1.0  # indefinite
    M = sp.DiagPrecond(diag_inv=jnp.asarray(dinv))
    b = jnp.ones(n, jnp.complex128)
    x0 = b + 3e-3 * jnp.eye(n, 1, dtype=jnp.complex128).ravel()  # near-solution
    x, info = cs_minres(A, b, x0, M=M, tol=1e-6, max_iter=50)
    st = int(info.status)
    assert st != Status.CONVERGED or float(info.residual) > 1e-6, (
        st, float(info.residual)
    )
    assert st == Status.INVALID_PRECONDITIONER, st
