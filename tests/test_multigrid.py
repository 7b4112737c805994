"""Geometric multigrid preconditioner: transfer adjointness, Galerkin
correctness, symmetry/PD of the V-cycle, and solver acceleration."""

import jax.numpy as jnp
import numpy as np
import pytest

import sprsolve_tpu as sp
from sprsolve_tpu import debug
from sprsolve_tpu.multigrid import (
    GridMGPrecond,
    _coarse_grid,
    prolong_grid,
    restrict_grid,
)
from sprsolve_tpu.utils import problems


def _spd_poisson2d(side):
    A, _ = problems.sym_grid_laplacian((side, side))
    return sp.csr_from_dense(-np.asarray(A.todense()))


@pytest.mark.parametrize("grid", [(7,), (8,), (5, 6), (8, 8), (3, 4, 5)])
def test_restrict_prolong_adjoint(grid):
    rng = np.random.default_rng(0)
    n = int(np.prod(grid))
    nc = int(np.prod(_coarse_grid(grid)))
    x = jnp.asarray(rng.standard_normal(n))
    y = jnp.asarray(rng.standard_normal(nc))
    lhs = float(jnp.vdot(restrict_grid(x, grid), y))
    rhs = float(jnp.vdot(x, prolong_grid(y, grid)))
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


def test_galerkin_matches_explicit_ptap():
    from sprsolve_tpu.multigrid import _galerkin_coarse

    grid = (6, 5)
    rng = np.random.default_rng(1)
    n = 30
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    A = sp.csr_from_dense(dense)
    Ac, coarse = _galerkin_coarse(A, grid)
    # explicit piecewise-constant aggregation P
    nc = int(np.prod(coarse))
    P = np.zeros((n, nc))
    for i in range(n):
        c = np.unravel_index(i, grid)
        P[i, np.ravel_multi_index(tuple(x // 2 for x in c), coarse)] = 1.0
    np.testing.assert_allclose(
        np.asarray(Ac.todense()), P.T @ dense @ P, atol=1e-13
    )


def test_vcycle_symmetric_positive_definite():
    A = _spd_poisson2d(8)
    M = GridMGPrecond.from_csr(A, (8, 8), coarse_max=8)
    n = 64
    cols = [
        np.asarray(M.matvec(jnp.zeros(n).at[i].set(1.0))) for i in range(n)
    ]
    dense = np.stack(cols, axis=1)
    np.testing.assert_allclose(dense, dense.T, rtol=1e-10, atol=1e-12)
    assert np.linalg.eigvalsh((dense + dense.T) / 2)[0] > 0


def test_is_linear_operator():
    A = _spd_poisson2d(8)
    M = GridMGPrecond.from_csr(A, (8, 8), coarse_max=8)
    assert debug.check_operator(M, jnp.zeros(64))


def test_accelerates_cg_and_nearly_grid_independent():
    iters = {}
    for side in (16, 32):
        A = _spd_poisson2d(side)
        M = GridMGPrecond.from_csr(A, (side, side), coarse_max=32)
        b = jnp.asarray(
            np.random.default_rng(2).standard_normal(side * side)
        )
        x, info = sp.cg(A.to_dia(), b, M=M, tol=1e-10, max_iter=500)
        info.raise_if_error()
        iters[side] = int(info.iterations)
        _, info_0 = sp.cg(A.to_dia(), b, tol=1e-10, max_iter=2000)
        assert iters[side] < int(info_0.iterations) // 3
        r = np.asarray(A.matvec(x)) - np.asarray(b)
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-8
    # multigrid hallmark: iteration count barely grows with the grid
    assert iters[32] <= iters[16] + 6


def test_minres_gate_passes():
    A = _spd_poisson2d(16)
    M = GridMGPrecond.from_csr(A, (16, 16), coarse_max=16)
    b = jnp.asarray(np.random.default_rng(3).standard_normal(256))
    _, info = sp.minres(A.to_dia(), b, M=M, tol=1e-10, max_iter=500)
    info.raise_if_error()


def test_3d_poisson_bicgstab():
    A = problems.poisson3d(8, 8, 8)
    M = GridMGPrecond.from_csr(A, (8, 8, 8), coarse_max=64)
    b = jnp.asarray(np.random.default_rng(4).standard_normal(512))
    x, info = sp.bicgstab(A.to_dia(), b, M=M, tol=1e-10, max_iter=500)
    info.raise_if_error()
    _, info_j = sp.bicgstab(
        A.to_dia(), b, M=sp.DiagPrecond.new(A.diagonal()), tol=1e-10,
        max_iter=500,
    )
    assert int(info.iterations) < int(info_j.iterations)
    r = np.asarray(A.matvec(x)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-8


def test_through_solve_api_padded_operator():
    # solve() optimizes the layout (DIA); the flat-layout MG preconditioner
    # applies directly
    A = problems.poisson3d(8, 8, 8)
    M = GridMGPrecond.from_csr(A, (8, 8, 8), coarse_max=64)
    b = np.random.default_rng(5).standard_normal(512)
    x, info = sp.solve(A, b, M=M, tol=1e-10, max_iter=500)
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x, jnp.float64))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def test_wrong_grid_raises():
    A = _spd_poisson2d(8)
    with pytest.raises(sp.errors.IncompatibleMatrixFormat):
        GridMGPrecond.from_csr(A, (8, 9))


def test_layout_kwargs_levels_match_default():
    """layout_kwargs reach optimize() for every level: with the banded
    routes closed the levels run as BSR, and the V-cycle is the same linear
    map."""
    A = problems.poisson3d(8, 8, 8)
    b = jnp.asarray(np.random.default_rng(6).standard_normal(512))
    M0 = GridMGPrecond.from_csr(A, (8, 8, 8), coarse_max=64)
    Mp = GridMGPrecond.from_csr(
        A, (8, 8, 8), coarse_max=64, max_diags=4, wide_diags=0
    )
    assert isinstance(M0.ops[0], sp.DIA)
    assert isinstance(Mp.ops[0], sp.BSR)
    z0 = np.asarray(M0.matvec(b))
    zp = np.asarray(Mp.matvec(b))
    np.testing.assert_allclose(zp, z0, rtol=1e-5, atol=1e-6)
    x, info = sp.cg(A.to_dia(), b, M=Mp, tol=1e-8, max_iter=200)
    info.raise_if_error()


def _unstructured_spd(n=600, seed=0):
    """Random geometric-graph Laplacian: SPD, no grid structure."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbrs = np.argsort(d2, axis=1)[:, :6]
    W = np.zeros((n, n))
    W[np.repeat(np.arange(n), 6), nbrs.ravel()] = 1.0
    W = np.maximum(W, W.T)
    L = np.diag(W.sum(1)) - W + 0.01 * np.eye(n)
    return sp.csr_from_dense(L), L


def test_amg_string_on_unstructured_matrix():
    A, L = _unstructured_spd()
    b = np.random.default_rng(1).standard_normal(600)
    x, info = sp.solve(A, b, method="cg", M="amg", tol=1e-8, max_iter=2000)
    info.raise_if_error()
    # answer comes back in the ORIGINAL ordering
    assert np.linalg.norm(L @ np.asarray(x) - b) / np.linalg.norm(b) < 1e-6
    _, info_j = sp.solve(A, b, method="cg", M="jacobi", tol=1e-8,
                         max_iter=2000)
    assert int(info.iterations) < int(info_j.iterations) // 2


def test_amg_rejects_operator_input():
    A, _ = _unstructured_spd(100, seed=2)
    with pytest.raises(sp.errors.InvalidPreconditioner):
        sp.solve(A.to_ell(), np.zeros(100), M="amg", tol=1e-8, max_iter=10)


def test_amg_with_cs_minres_raises():
    A, _ = _unstructured_spd(100, seed=3)
    Ac = sp.CSR.from_arrays(
        np.asarray(A.data, np.complex128), A.indices, A.indptr, A.shape
    )
    with pytest.raises(sp.errors.InvalidPreconditioner):
        sp.solve(Ac, np.zeros(100, complex), method="cs_minres", M="amg",
                 tol=1e-8, max_iter=10)
