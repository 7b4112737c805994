"""Block-Jacobi preconditioner and Lanczos spectral-bound estimation.

BlockJacobiPrecond is the batched dense-block generalization of the reference's
``DiagPrecond`` (``src/precond.rs``); these tests pin its apply to the dense
block-diagonal-inverse oracle and verify it accelerates and stays valid for
the SPD-gated solvers.
"""

import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu import debug
from sprsolve_tpu.utils import problems


def _spd_poisson(side=16):
    A, _ = problems.sym_grid_laplacian((side, side))
    dense = -np.asarray(A.todense())
    return sp.csr_from_dense(dense)


def _blockdiag_inv_oracle(dense, bs):
    n = dense.shape[0]
    out = np.zeros_like(dense)
    for s in range(0, n, bs):
        e = min(s + bs, n)
        out[s:e, s:e] = np.linalg.inv(dense[s:e, s:e])
    return out


def test_apply_matches_dense_blockdiag_inverse():
    rng = np.random.default_rng(0)
    n, bs = 50, 8  # n not a multiple of bs: exercises padded tail block
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    dense += np.eye(n) * 5.0
    A = sp.csr_from_dense(dense)
    M = sp.BlockJacobiPrecond.from_csr(A, block_size=bs)
    r = rng.standard_normal(n)
    got = np.asarray(M.matvec(jnp.asarray(r)))
    want = _blockdiag_inv_oracle(dense, bs) @ r
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_block_size_one_equals_diag_precond():
    A = _spd_poisson(8)
    M1 = sp.BlockJacobiPrecond.from_csr(A, block_size=1)
    Md = sp.DiagPrecond.new(A.diagonal())
    r = jnp.asarray(np.random.default_rng(1).standard_normal(64))
    np.testing.assert_allclose(
        np.asarray(M1.matvec(r)), np.asarray(Md.matvec(r)), rtol=1e-12
    )


def test_is_linear_operator():
    A = _spd_poisson(8)
    M = sp.BlockJacobiPrecond.from_csr(A, block_size=16)
    assert debug.check_operator(M, jnp.zeros(64))


def test_hermitian_apply_complex():
    rng = np.random.default_rng(2)
    n, bs = 24, 6
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    dense = h @ h.conj().T + np.eye(n) * n  # HPD
    A = sp.csr_from_dense(dense)
    M = sp.BlockJacobiPrecond.from_csr(A, block_size=bs)
    r = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.asarray(M.matvec(jnp.asarray(r)))
    want = _blockdiag_inv_oracle(dense, bs) @ r
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    # HPD apply: rᴴ M⁻¹ r real positive (MINRES β² gate)
    quad = np.vdot(r, got)
    assert abs(quad.imag) < 1e-10 * abs(quad)
    assert quad.real > 0


def test_accelerates_cg_and_passes_minres_gate():
    A = _spd_poisson()
    b = jnp.asarray(np.random.default_rng(3).standard_normal(256))
    M = sp.BlockJacobiPrecond.from_csr(A, block_size=16)
    x_p, info_p = sp.cg(A.to_dia(), b, M=M, tol=1e-10, max_iter=2000)
    info_p.raise_if_error()
    _, info_0 = sp.cg(A.to_dia(), b, tol=1e-10, max_iter=2000)
    info_0.raise_if_error()
    assert int(info_p.iterations) < int(info_0.iterations)
    r = np.asarray(A.matvec(x_p)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-8
    # MINRES with the HPD apply must not trip InvalidPreconditioner
    _, info_m = sp.minres(A.to_dia(), b, M=M, tol=1e-10, max_iter=2000)
    info_m.raise_if_error()


def test_singular_block_raises():
    import pytest

    dense = np.zeros((4, 4))
    dense[2, 3] = dense[3, 2] = 1.0  # block (0:2,0:2) all-zero → singular
    dense[0, 2] = 1.0
    A = sp.csr_from_dense(dense)
    with pytest.raises(sp.errors.InvalidPreconditioner):
        sp.BlockJacobiPrecond.from_csr(A, block_size=2)


def test_solve_api_string():
    A = _spd_poisson()
    b = np.random.default_rng(4).standard_normal(256)
    x, info = sp.solve(A, b, method="cg", M="block_jacobi", tol=1e-10,
                       max_iter=2000)
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def test_estimate_spectral_bounds_brackets_spectrum():
    A = _spd_poisson()
    dense = np.asarray(A.todense())
    ev = np.linalg.eigvalsh(dense)
    lmin, lmax = sp.estimate_spectral_bounds(A, m=40, seed=0)
    assert lmin > 0
    assert lmax >= ev[-1] * 0.999  # safety factor widens past the top Ritz
    assert lmin <= ev[0] * 1.001 or lmin <= ev[0] + 0.05 * (ev[-1] - ev[0])
    assert lmax <= ev[-1] * 1.2


def test_chebyshev_auto():
    A = _spd_poisson()
    b = jnp.asarray(np.random.default_rng(5).standard_normal(256))
    M = sp.ChebyshevPrecond.auto(A.to_dia(), degree=6, lanczos_iters=30)
    x_p, info_p = sp.minres(A.to_dia(), b, M=M, tol=1e-10, max_iter=2000)
    info_p.raise_if_error()
    _, info_0 = sp.minres(A.to_dia(), b, tol=1e-10, max_iter=2000)
    assert int(info_p.iterations) < int(info_0.iterations) // 2
    r = np.asarray(A.matvec(x_p)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-8


def test_chebyshev_auto_rejects_indefinite():
    import pytest

    A, _ = problems.sym_grid_laplacian((8, 8))  # negative definite as built
    with pytest.raises(sp.errors.InvalidPreconditioner):
        sp.ChebyshevPrecond.auto(sp.csr_from_dense(np.asarray(A.todense())))
