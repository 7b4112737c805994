"""Hybrid band+outlier operator (HybridDIA) and its optimize() routing.

The round-4 cliff: ONE long-range entry made the diagonal count explode
past every DIA/RCM threshold and dropped the whole matrix to the warned
ELL gather path.  The hybrid split keeps the banded core on the kernel
path and prices the spill at the measured scatter rate.  Oracle: scipy.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps

import sprsolve_tpu as sp
from sprsolve_tpu.ops.hybrid import HybridDIA
from sprsolve_tpu.ops.optimize import optimize
from sprsolve_tpu.ops.reordered import Reordered


def _poisson_plus_outliers(side=40, n_out=60, seed=0, dtype=np.float64):
    """2-D Poisson + a few random long-range couplings (constraint rows)."""
    from sprsolve_tpu.utils import problems

    A, _ = problems.sym_grid_laplacian((side, side))
    n = side * side
    S = sps.csr_matrix(
        (np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
        shape=A.shape,
    ).astype(dtype)
    S = -S  # positive definite
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, n_out)
    c = rng.integers(0, n, n_out)
    v = rng.standard_normal(n_out).astype(dtype) * 0.01
    O = sps.coo_matrix((np.concatenate([v, v]),
                        (np.concatenate([r, c]), np.concatenate([c, r]))),
                       shape=(n, n)).tocsr()  # keep it symmetric
    return (S + O).tocsr()


def test_matvec_matches_scipy():
    S = _poisson_plus_outliers()
    A = sp.csr_from_scipy(S)
    H = HybridDIA.from_csr(A, max_diags=8)
    assert H.n_outliers > 0
    x = np.random.default_rng(1).standard_normal(S.shape[0])
    got = np.asarray(H.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, S @ x, rtol=1e-12, atol=1e-12)
    # diagonal stays in the core and reads back exactly
    np.testing.assert_allclose(np.asarray(H.diagonal()), S.diagonal(),
                               rtol=1e-12)


def test_matvec_matches_scipy_f32_pallas_core():
    S = _poisson_plus_outliers(dtype=np.float32)
    A = sp.csr_from_scipy(S)
    H = HybridDIA.from_csr(A, max_diags=8)
    assert isinstance(H.core, sp.DIA) and H.core.dtype == jnp.float32
    x = np.random.default_rng(1).standard_normal(S.shape[0]).astype(np.float32)
    got = np.asarray(H.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, S @ x, rtol=2e-5, atol=2e-5)


def test_spill_budget_raises():
    # uniform random: no dominant offsets -> the split must refuse
    S = sps.random(400, 400, density=0.05, random_state=0, format="csr")
    S.setdiag(S.diagonal() + 10.0)
    with pytest.raises(ValueError):
        HybridDIA.from_csr(sp.csr_from_scipy(S.tocsr()), max_diags=8,
                           max_outliers=100)


def _poisson3d_plus_outliers(nx=24, n_out=60, seed=0, dtype=np.float32):
    """3-D Poisson (wide stencil offsets defeat BSR blocking) + couplings."""
    from sprsolve_tpu.utils import problems

    A = problems.poisson3d(nx, nx, nx, dtype=dtype)
    n = A.shape[0]
    S = sps.csr_matrix(
        (np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
        shape=A.shape,
    )
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, n_out)
    c = rng.integers(0, n, n_out)
    v = rng.standard_normal(n_out).astype(dtype) * 0.01
    O = sps.coo_matrix((np.concatenate([v, v]),
                        (np.concatenate([r, c]), np.concatenate([c, r]))),
                       shape=(n, n)).tocsr()
    return (S + O).tocsr().astype(dtype)


def test_optimize_routes_spiked_pattern_to_hybrid():
    """3-D Poisson + a few couplings: the banded core must survive as a
    hybrid split (one long-range row used to disqualify the whole fast
    path -> warned ELL at ~0.1 Gnnz/s)."""
    S = _poisson3d_plus_outliers()
    A = sp.csr_from_scipy(S)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any ELL RuntimeWarning -> failure
        op = optimize(A)
    inner = op.inner if isinstance(op, Reordered) else op
    assert isinstance(inner, HybridDIA), type(inner)
    x = np.random.default_rng(2).standard_normal(S.shape[0]).astype(np.float32)
    if hasattr(op, "pad_vec"):
        got = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(jnp.asarray(x)))))
    else:
        got = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, S @ x, rtol=2e-4, atol=2e-4)


def test_optimize_keeps_uniform_random_off_hybrid():
    """No dominant offsets -> the hybrid split must not be chosen (its
    sidecar pricing keeps it out); routing falls to the other layouts."""
    S = sps.random(600, 600, density=0.03, random_state=1, format="csr")
    S.setdiag(S.diagonal() + 10.0)
    A = sp.csr_from_scipy(S.tocsr())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        op = optimize(A)
    inner = op.inner if isinstance(op, Reordered) else op
    assert not isinstance(inner, HybridDIA)
    x = np.random.default_rng(2).standard_normal(600)
    if hasattr(op, "pad_vec"):
        got = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(jnp.asarray(x)))))
    else:
        got = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, S @ x, rtol=1e-10, atol=1e-10)


def test_solve_end_to_end_on_hybrid():
    S = _poisson_plus_outliers(n_out=30)
    A = sp.csr_from_scipy(S)
    b = np.random.default_rng(3).standard_normal(S.shape[0])
    x, info = sp.solve(A, b, method="bicgstab", M="jacobi", tol=1e-10,
                       max_iter=2000)
    info.raise_if_error()
    r = S @ np.asarray(x) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-10
