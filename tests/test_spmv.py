"""SpMV tests — ports the reference's hand-built 5×5 fixtures with hard-coded
expected outputs (``src/mat.rs:203-281``) and its MKL cross-checks (complex
SpMV and fused dotmv vs ``vecalg::conj_dot``, ``src/mkl_mat.rs:336-464``),
then additionally validates every execution layout (ELL, DIA) against the
CSR oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from sprsolve_tpu import COO, CSR, DIA, ELL, vecalg
from sprsolve_tpu.ops.spmv import spmv_coo, spmv_csr, spmv_dia, spmv_ell
from sprsolve_tpu.utils import problems

EPS = 1e-8


def _ref_csr():
    # src/mat.rs:232-255 (dense_csr_mat)
    indptr = [0, 3, 3, 5, 6, 7]
    indices = [1, 2, 3, 2, 3, 4, 4]
    data = [0.75672424, 0.1649078, 0.30140296, 0.10358244, 0.6283315, 0.39244208, 0.57202407]
    return CSR.from_arrays(np.array(data), np.array(indices), np.array(indptr), (5, 5))


def test_csr_spmv_reference_values():
    mat = _ref_csr()
    v = jnp.asarray([0.1, 0.2, -0.1, 0.3, 0.9])
    expected = [0.22527496, 0.0, 0.17814121, 0.35319787, 0.51482166]
    np.testing.assert_allclose(spmv_csr(mat, v), expected, atol=EPS)


def test_csc_spmv_reference_values():
    # src/mat.rs:208-229 (dense_csc_mat) via the COO path (the CSC container
    # itself is exercised in test_csc_container_matches_reference_values).
    indptr = np.array([0, 2, 4, 5, 6, 7])
    indices = np.array([2, 3, 3, 4, 2, 1, 3])  # row indices per column
    data = np.array(
        [0.35310881, 0.42380633, 0.28035896, 0.58082095, 0.53350123, 0.88132896, 0.72527863]
    )
    cols = np.repeat(np.arange(5), np.diff(indptr))
    coo = COO(
        data=jnp.asarray(data),
        row=jnp.asarray(indices, dtype=jnp.int32),
        col=jnp.asarray(cols, dtype=jnp.int32),
        shape=(5, 5),
    )
    v = jnp.asarray([0.1, 0.2, -0.1, 0.3, 0.9])
    expected = [0.0, 0.26439869, -0.01803924, 0.75120319, 0.11616419]
    np.testing.assert_allclose(spmv_coo(coo, v), expected, atol=EPS)


def test_empty_rows_produce_zero():
    mat = _ref_csr()  # row 1 is empty
    v = jnp.ones(5)
    out = np.asarray(spmv_csr(mat, v))
    assert out[1] == 0.0


@pytest.mark.parametrize("layout", ["ell", "dia"])
def test_layouts_match_csr_oracle(layout):
    A = problems.grid_laplacian_dirichlet((12, 12))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(144))
    want = spmv_csr(A, x)
    if layout == "ell":
        got = spmv_ell(A.to_ell(), x)
    else:
        got = spmv_dia(A.to_dia(), x)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


def test_complex_spmv_and_fused_dot():
    # analog of the MKL complex SpMV + dotmv cross-check (src/mkl_mat.rs:400-464)
    A, rhs = problems.hermitian_grid((6, 6))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(36) + 1j * rng.standard_normal(36))
    y = A.matvec(x)
    dense = np.asarray(A.todense())
    np.testing.assert_allclose(y, dense @ np.asarray(x), rtol=1e-13)
    y2, d = A.matvec_dot(x)
    np.testing.assert_allclose(y2, y, rtol=1e-15)
    np.testing.assert_allclose(d, vecalg.conj_dot(x, y), rtol=1e-13)


def test_ell_padding_is_inert():
    A = problems.grid_laplacian_dirichlet((10, 10))
    ell5 = A.to_ell()
    ell8 = A.to_ell(k=8)
    assert ell5.k == 5 and ell8.k == 8
    x = jnp.asarray(np.random.default_rng(2).standard_normal(100))
    np.testing.assert_array_equal(
        np.asarray(spmv_ell(ell5, x)), np.asarray(spmv_ell(ell8, x))
    )


def test_dia_roundtrip_structure():
    A = problems.grid_laplacian_dirichlet((9, 9))
    dia = A.to_dia()
    assert 0 in dia.offsets
    np.testing.assert_allclose(
        np.asarray(dia.diagonal()), np.asarray(A.diagonal()), rtol=1e-15
    )


def test_duplicate_coo_entries_sum():
    coo = COO(
        data=jnp.asarray([1.0, 2.0, 3.0]),
        row=jnp.asarray([0, 0, 1], dtype=jnp.int32),
        col=jnp.asarray([0, 0, 1], dtype=jnp.int32),
        shape=(2, 2),
    )
    np.testing.assert_allclose(
        np.asarray(coo.todense()), np.array([[3.0, 0.0], [0.0, 3.0]])
    )
    csr = coo.to_csr()
    assert csr.nnz == 2
    np.testing.assert_allclose(np.asarray(csr.todense()), np.asarray(coo.todense()))


def test_csc_container_matches_reference_values():
    from sprsolve_tpu import CSC

    # the reference CSC fixture (src/mat.rs:208-229) through the CSC container
    indptr = np.array([0, 2, 4, 5, 6, 7])
    indices = np.array([2, 3, 3, 4, 2, 1, 3])
    data = np.array(
        [0.35310881, 0.42380633, 0.28035896, 0.58082095, 0.53350123, 0.88132896, 0.72527863]
    )
    mat = CSC.from_arrays(data, indices, indptr, (5, 5))
    v = jnp.asarray([0.1, 0.2, -0.1, 0.3, 0.9])
    expected = [0.0, 0.26439869, -0.01803924, 0.75120319, 0.11616419]
    np.testing.assert_allclose(mat.matvec(v), expected, atol=EPS)
    # CSC -> CSR roundtrip preserves the matrix
    np.testing.assert_allclose(
        np.asarray(mat.to_csr().todense()), np.asarray(mat.todense()), atol=1e-15
    )


def test_spmm_matches_column_matvecs():
    from sprsolve_tpu.ops.spmv import spmm_csr, spmm_dia, spmm_ell

    A = problems.grid_laplacian_dirichlet((10, 10))
    X = jnp.asarray(np.random.default_rng(3).standard_normal((100, 4)))
    want = np.stack([np.asarray(A.matvec(X[:, j])) for j in range(4)], axis=1)
    for got in (
        spmm_csr(A, X),
        spmm_ell(A.to_ell(), X),
        spmm_dia(A.to_dia(), X),
        A.matmat(X),
    ):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-14, atol=1e-14)
