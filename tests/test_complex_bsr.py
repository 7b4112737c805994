"""ComplexBSR: the unstructured-complex fast path (two-plane dense blocks).

Parity bar: the reference's MKL backend runs arbitrary complex CSR at memory
speed (``src/mkl_mat.rs:32-74,170-319`` — the c/z creation and mv macros);
these tests certify the counterpart's correctness, its routing through
``optimize()``, and its use inside solvers and complex refinement.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import sprsolve_tpu as sp
from sprsolve_tpu.sparse.bsr import ComplexBSR
from sprsolve_tpu.utils import problems


def _random_complex_csr(n=300, density=0.03, seed=0, diag=6.0):
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    S = sps.random(n, n, density=density, random_state=seed, format="csr")
    S = S + sps.eye(n) * diag
    data = S.data.astype(np.complex128) * (
        1.0 + 1j * rng.standard_normal(S.nnz)
    )
    Sc = sps.csr_matrix((data, S.indices, S.indptr), shape=S.shape)
    return sp.csr_from_scipy(Sc), Sc


def test_complex_bsr_matches_csr_oracle():
    A, Sc = _random_complex_csr()
    cb = ComplexBSR.from_csr(A, bs=32)
    assert cb.shape == (300, 300)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    got = np.asarray(cb.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, Sc @ x, rtol=1e-5, atol=1e-5)
    # fused dot = conj(x)·(A·x)
    y, d = cb.matvec_dot(jnp.asarray(x))
    np.testing.assert_allclose(
        complex(d), np.vdot(x, Sc @ x), rtol=1e-5, atol=1e-4
    )


def test_complex_bsr_matmat_and_diagonal():
    A, Sc = _random_complex_csr(n=200, seed=2)
    cb = ComplexBSR.from_csr(A, bs=64)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((200, 3)) + 1j * rng.standard_normal((200, 3))
    np.testing.assert_allclose(
        np.asarray(cb.matmat(jnp.asarray(X))), Sc @ X, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(cb.diagonal()), Sc.diagonal(), rtol=1e-12
    )


def test_complex_bsr_padding_non_multiple():
    A, Sc = _random_complex_csr(n=173, seed=4)  # not a bs multiple
    cb = ComplexBSR.from_csr(A, bs=32)
    assert cb.padded_dim % 32 == 0 and cb.shape == (173, 173)
    x = np.random.default_rng(5).standard_normal(173) * (1 + 0.5j)
    np.testing.assert_allclose(
        np.asarray(cb.matvec(jnp.asarray(x))), Sc @ x, rtol=1e-5, atol=1e-5
    )


def test_optimize_routes_unstructured_complex_to_bsr():
    """An unstructured complex matrix must land on a structured layout (the
    two-plane BSR, a reordered DIA or the band+outlier split), never on the
    warned ELL gather path."""
    A, Sc = _random_complex_csr(n=300, seed=6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the ELL fallback warns — fail then
        op = sp.optimize(A)

    def inner_of(o):
        return o.inner if hasattr(o, "inner") else o

    assert isinstance(inner_of(op), (ComplexBSR, sp.DIA, sp.HybridDIA)), type(op)
    x = np.random.default_rng(7).standard_normal(300) + 0j
    if hasattr(op, "pad_vec"):
        got = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(jnp.asarray(x)))))
    else:
        got = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, Sc @ x, rtol=1e-5, atol=1e-5)


def test_bicgstab_through_complex_bsr():
    A, Sc = _random_complex_csr(n=256, seed=8, diag=12.0)
    cb = ComplexBSR.from_csr(A, bs=32)
    rng = np.random.default_rng(9)
    x_true = rng.standard_normal(256) + 1j * rng.standard_normal(256)
    b = jnp.asarray(Sc @ x_true)
    M = cb.jacobi_precond()
    x, info = sp.bicgstab(cb, b, M=M, tol=1e-10, max_iter=500)
    info.raise_if_error()
    r = Sc @ np.asarray(x) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-9


def test_refine_complex_nonbanded_routes_off_gather_path():
    """refine_solve's non-banded c128 inner operator must ride the
    ComplexBSR (or RCM-banded) path, not gather-speed CSR planes."""
    import importlib

    refine_mod = importlib.import_module("sprsolve_tpu.solvers.refine")

    A, Sc = _random_complex_csr(n=200, seed=10, diag=14.0)
    A32 = refine_mod._complex_inner_operator(
        A, np.asarray(A.data, np.complex128)
    )
    assert not isinstance(A32, refine_mod._PlanesComplexOp)

    def inner_of(o):
        return o.inner if hasattr(o, "inner") else o

    assert isinstance(
        inner_of(A32), (ComplexBSR, sp.DIA, sp.HybridDIA)
    ), type(A32)

    # and the full refine_solve converges to c128 accuracy through it
    rng = np.random.default_rng(11)
    x_true = rng.standard_normal(200) + 1j * rng.standard_normal(200)
    b = Sc @ x_true
    x, info = refine_mod.refine_solve(
        A, b, inner="bicgstab", M="jacobi", tol=1e-12, inner_max_iter=300
    )
    r = Sc @ np.asarray(x) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-11
    assert float(info.residual) <= 1e-12


def test_real_abs_jacobi_covers_every_operator_class():
    """The shared |d|-Jacobi dispatcher (review finding): planes-CSR
    fallback, ComplexBSR via generic diagonal, Reordered recursion."""
    import importlib

    from sprsolve_tpu.precond import DiagPrecond, real_abs_jacobi

    refine_mod = importlib.import_module("sprsolve_tpu.solvers.refine")
    A, Sc = _random_complex_csr(n=120, seed=12, diag=9.0)
    data = np.asarray(A.data, np.complex128)

    planes = refine_mod._PlanesComplexOp(
        re=sp.CSR.from_arrays(data.real.astype(np.float32), A.indices,
                              A.indptr, A.shape),
        im=sp.CSR.from_arrays(data.imag.astype(np.float32), A.indices,
                              A.indptr, A.shape),
    )
    want = 1.0 / np.abs(Sc.diagonal())
    M1 = real_abs_jacobi(planes)
    assert isinstance(M1, DiagPrecond)
    np.testing.assert_allclose(np.asarray(M1.diag_inv), want, rtol=1e-5)

    cb = ComplexBSR.from_csr(A, bs=32)
    M2 = real_abs_jacobi(cb)
    np.testing.assert_allclose(np.asarray(M2.diag_inv), want, rtol=1e-5)

    from sprsolve_tpu.ops.reordered import Reordered

    perm = np.random.default_rng(13).permutation(120)
    M3 = real_abs_jacobi(Reordered.wrap(cb, perm))
    # Reordered recursion: built from the INNER (solve-space) diagonal
    np.testing.assert_allclose(
        np.asarray(M3.diag_inv), np.asarray(M2.diag_inv), rtol=1e-6
    )
