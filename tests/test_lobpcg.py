"""LOBPCG block eigensolver: dense-eigh oracles, preconditioning, complex."""

import jax
import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.utils import problems


def _spd_poisson(side=16):
    A, _ = problems.sym_grid_laplacian((side, side))
    dense = -np.asarray(A.todense())
    return sp.csr_from_dense(dense), dense


def test_smallest_pairs_match_dense_eigh():
    A, dense = _spd_poisson()
    ev = np.linalg.eigvalsh(dense)
    X0 = jnp.asarray(np.random.default_rng(0).standard_normal((256, 4)))
    lam, X, info = sp.lobpcg(A, X0, tol=1e-9, max_iter=400)
    info.raise_if_error()
    np.testing.assert_allclose(np.asarray(lam), ev[:4], atol=1e-7)
    # eigenvector residuals against the dense matrix
    Xn = np.asarray(X)
    R = dense @ Xn - Xn * np.asarray(lam)[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6
    # orthonormality
    np.testing.assert_allclose(Xn.T @ Xn, np.eye(4), atol=1e-8)


def test_largest_pairs():
    A, dense = _spd_poisson()
    ev = np.linalg.eigvalsh(dense)
    X0 = jnp.asarray(np.random.default_rng(1).standard_normal((256, 3)))
    lam, _, info = sp.lobpcg(A, X0, largest=True, tol=1e-9, max_iter=400)
    info.raise_if_error()
    np.testing.assert_allclose(np.asarray(lam), ev[-3:], atol=1e-7)


def test_preconditioning_accelerates():
    A, dense = _spd_poisson()
    X0 = jnp.asarray(np.random.default_rng(2).standard_normal((256, 4)))
    _, _, info_0 = sp.lobpcg(A.to_dia(), X0, tol=1e-8, max_iter=400)
    M = sp.ChebyshevPrecond.auto(A.to_dia(), degree=8)
    lam, _, info_p = sp.lobpcg(A.to_dia(), X0, M=M, tol=1e-8, max_iter=400)
    info_p.raise_if_error()
    assert int(info_p.iterations) < int(info_0.iterations) // 2
    ev = np.linalg.eigvalsh(dense)
    np.testing.assert_allclose(np.asarray(lam), ev[:4], atol=1e-6)


def test_complex_hermitian():
    rng = np.random.default_rng(3)
    n = 80
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    dense = (h + h.conj().T) / 2
    A = sp.csr_from_dense(dense)
    ev = np.linalg.eigvalsh(dense)
    X0 = jnp.asarray(
        rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    )
    lam, X, info = sp.lobpcg(A, X0, tol=1e-9, max_iter=600)
    info.raise_if_error()
    np.testing.assert_allclose(np.asarray(lam), ev[:3], atol=1e-6)
    Xn = np.asarray(X)
    R = dense @ Xn - Xn * np.asarray(lam)[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-5


def test_under_jit():
    A, dense = _spd_poisson(10)
    X0 = jnp.asarray(np.random.default_rng(4).standard_normal((100, 2)))

    run = jax.jit(lambda a, x0: sp.lobpcg(a, x0, tol=1e-8, max_iter=300))
    lam, _, info = run(A.to_dia(), X0)
    info.raise_if_error()
    ev = np.linalg.eigvalsh(dense)
    np.testing.assert_allclose(np.asarray(lam), ev[:2], atol=1e-6)


def test_insufficient_iterations_status():
    A, _ = _spd_poisson()
    X0 = jnp.asarray(np.random.default_rng(5).standard_normal((256, 4)))
    _, _, info = sp.lobpcg(A, X0, tol=1e-12, max_iter=2)
    assert int(info.status) == sp.errors.Status.INSUFFICIENT_ITER


def test_block_too_large_raises():
    import pytest

    A, _ = _spd_poisson(4)
    with pytest.raises(sp.errors.IncompatibleMatrixFormat):
        sp.lobpcg(A, jnp.zeros((16, 6)), tol=1e-8, max_iter=10)


def test_scipy_compat_lobpcg():
    from sprsolve_tpu import scipy_compat

    A, dense = _spd_poisson()
    X0 = np.random.default_rng(6).standard_normal((256, 4))
    w, v = scipy_compat.lobpcg(A, X0, tol=1e-8, maxiter=400)
    ev = np.linalg.eigvalsh(dense)
    # scipy's lobpcg defaults to largest=True
    np.testing.assert_allclose(np.sort(np.asarray(w)), ev[-4:], atol=1e-6)
    assert np.asarray(v).shape == (256, 4)


def test_padded_kernel_operator():
    # an operator with its own (permuted) vector layout: lobpcg must accept
    # it (auto flat-view) and match the flat-operator result
    A, dense = _spd_poisson(10)
    from sprsolve_tpu.ops.reordered import Reordered

    op = Reordered.wrap(
        sp.CSR.from_arrays(
            np.asarray(A.data, np.float32), A.indices, A.indptr, A.shape
        ).to_dia(),
        np.arange(100)[::-1],
    )
    assert hasattr(op, "pad_vec")
    X0 = jnp.asarray(
        np.random.default_rng(7).standard_normal((100, 2)), jnp.float32
    )
    lam, _, info = sp.lobpcg(op, X0, tol=1e-4, max_iter=300)
    info.raise_if_error()
    ev = np.linalg.eigvalsh(dense)
    np.testing.assert_allclose(np.asarray(lam), ev[:2], atol=1e-3)


def test_buffer_accelerates_clustered_pair():
    """Guard-buffer heuristic: lambda_k inside a tight cluster converges
    slowly (rate ~ gap to the first eigenvalue outside the block); buffer
    columns move that boundary past the cluster.  The buffered run must
    reach the same pairs in fewer iterations, and the buffer columns must
    not leak into the returned block."""
    n = 200
    d = np.arange(1.0, n + 1.0)
    d[3] = 4.0 + 1e-4  # lambda_4 clustered against lambda_3 (k=4 wanted)
    A = sp.csr_from_dense(np.diag(d))
    X0 = jnp.asarray(np.random.default_rng(5).standard_normal((n, 4)))
    lam0, _, info0 = sp.lobpcg(A, X0, tol=1e-8, max_iter=500)
    lamb, Xb, infob = sp.lobpcg(A, X0, tol=1e-8, max_iter=500, buffer=4)
    infob.raise_if_error()
    ref = np.sort(d)[:4]
    np.testing.assert_allclose(np.asarray(lamb), ref, rtol=0, atol=1e-5)
    assert Xb.shape == (n, 4) and lamb.shape == (4,)
    # acceleration: the unbuffered run is gap-limited on the clustered pair
    assert int(infob.iterations) < int(info0.iterations)


def test_buffer_clamps_to_block_bound():
    """3(k+buffer) < n must keep holding: an oversized buffer is clamped,
    not an error."""
    n = 30
    A = sp.csr_from_dense(np.diag(np.arange(1.0, n + 1.0)))
    X0 = jnp.asarray(np.random.default_rng(6).standard_normal((n, 3)))
    lam, X, info = sp.lobpcg(A, X0, tol=1e-8, max_iter=300, buffer=100)
    info.raise_if_error()
    np.testing.assert_allclose(np.asarray(lam), [1.0, 2.0, 3.0], atol=1e-6)
    assert X.shape == (n, 3)


def test_multigrid_preconditioned_lobpcg():
    """M = GridMGPrecond (~A^-1) as the LOBPCG preconditioner: the
    smallest Poisson eigenvalues cluster at O(h^2) and unpreconditioned
    convergence is gap-limited; the V-cycle restores it (12 vs 80+ iters
    at 24^3 in f32). Also pins the combination docs/preconditioners.md
    advertises — it was untested before round 4 (found together with the
    default-precision matmul bug this file's solver now guards against)."""
    n_side = 16
    A = problems.poisson3d(n_side, n_side, n_side, dtype=np.float32)
    M = sp.GridMGPrecond.from_csr(A, (n_side,) * 3)
    X0 = jnp.asarray(
        np.random.default_rng(7).standard_normal((A.shape[0], 4)).astype(
            np.float32
        )
    )
    dia = A.to_dia()
    lam_p, _, info_p = sp.lobpcg(dia, X0, M=M, tol=5e-4, max_iter=60)
    info_p.raise_if_error()
    import math

    l1 = 3 * (2 * math.sin(math.pi / (2 * (n_side + 1)))) ** 2
    assert abs(float(lam_p[0]) - l1) < 5e-3 * l1 + 1e-4
    # and it genuinely accelerates: unpreconditioned needs more iterations
    _, _, info_u = sp.lobpcg(dia, X0, tol=5e-4, max_iter=60)
    assert int(info_p.iterations) < max(int(info_u.iterations), 60)
