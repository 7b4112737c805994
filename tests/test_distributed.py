"""Distributed-solve tests on a virtual 8-device CPU mesh — the same
shard_map/psum/ppermute code paths that run on a multi-GPU mesh (SURVEY.md
§4: test multi-device logic without the devices via the host-platform
device-count override)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sprsolve_tpu as sp
from sprsolve_tpu.parallel import (
    AllGatherELL,
    HaloDIA,
    distributed_solve,
    partition_csr,
    partition_dia,
)
from sprsolve_tpu.utils import problems


def _dirichlet(shape):
    A = problems.grid_laplacian_dirichlet(shape)
    rhs = np.zeros(shape[0] * shape[1])
    problems.set_boundary_condition(rhs, shape, lambda r, c: float(r + c))
    return A, rhs


def test_mesh_available():
    assert len(jax.devices()) == 8


def test_distributed_spmv_matches_local():
    """Both halo strategies must reproduce the local SpMV exactly (the
    summation structure per row is unchanged — only x sourcing differs)."""
    A, _ = _dirichlet((16, 16))
    n = 256
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n))
    want = np.asarray(A.matvec(x))

    mesh = jax.make_mesh((8,), ("rows",))
    from jax.sharding import PartitionSpec as P

    for parts in (partition_csr(A, 8), partition_dia(A.to_dia(), 8)):
        with jax.set_mesh(mesh):
            y = jax.shard_map(
                lambda op, xl: op.matvec(xl),
                mesh=mesh,
                in_specs=(parts.pspec("rows"), P("rows")),
                out_specs=P("rows"),
            )(parts, x)
        np.testing.assert_allclose(np.asarray(y), want, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("layout", ["ell", "dia"])
def test_distributed_bicgstab(layout):
    A, rhs = _dirichlet((20, 20))
    op = A if layout == "ell" else A.to_dia()
    x, info = distributed_solve(sp.bicgstab, op, rhs, tol=1e-15, max_iter=1500)
    info.raise_if_error()
    r = np.asarray(A.matvec(x)) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-12


def test_distributed_padding_exact():
    # 100 rows over 8 devices → 104 with identity pad rows; padding must be
    # exact, not approximate.
    A, rhs = _dirichlet((10, 10))
    x_d, info = distributed_solve(sp.bicgstab, A, rhs, tol=1e-15, max_iter=1500)
    info.raise_if_error()
    assert x_d.shape == (100,)
    r = np.asarray(A.matvec(x_d)) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-12


def test_distributed_precond_minres_complex():
    A, rhs, diag = problems.hermitian_grid_with_diag((8, 8))
    M = sp.DiagPrecond.new(diag)
    x, info = distributed_solve(sp.minres, A, rhs, M=M, tol=1e-22, max_iter=300)
    info.raise_if_error()
    xk = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(x) - xk).max() < 1e-12


def test_distributed_cs_minres():
    A, rhs, _ = problems.complex_symmetric_grid_with_diag((8, 8))
    x, info = distributed_solve(sp.cs_minres, A, rhs, tol=1e-22, max_iter=300)
    info.raise_if_error()
    xk = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(x) - xk).max() < 1e-12


def test_halo_dia_rejects_wide_bands():
    # bandwidth must fit within a device's row block
    A, _ = _dirichlet((4, 4))  # n=16, 8 devices → 2 rows each; offsets ±4
    with pytest.raises(ValueError):
        partition_dia(A.to_dia(), 8)


def test_distributed_masked_gs_precond():
    """Multicolor GS preconditioning under shard_map: the masked formulation
    distributes for free (SpMV + elementwise), closing the reference's
    'Gauss-Seidel is sequential' gap even across chips."""
    A, rhs = _dirichlet((20, 20))
    from sprsolve_tpu.parallel import partition_dia
    from sprsolve_tpu.solvers.redblack import MaskedGSPrecond

    colors = sp.greedy_color(A)
    op = partition_dia(A.to_dia(), 8)
    M = MaskedGSPrecond(
        A=op,
        diag=A.diagonal(),
        masks=sp.color_masks(colors),
        sweeps=1,
    )
    x, info = distributed_solve(
        sp.bicgstab, op, jnp.asarray(rhs), M=M, tol=1e-14, max_iter=1500
    )
    info.raise_if_error()
    r = np.asarray(A.matvec(x)) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-11
    # preconditioning must actually help
    _, info_j = distributed_solve(
        sp.bicgstab, op, jnp.asarray(rhs), tol=1e-14, max_iter=1500
    )
    assert int(info.iterations) < int(info_j.iterations) // 2


def test_distributed_cg():
    """CG's psum inner products and fused matvec_dot under shard_map: the
    distributed SPD path must converge to the same answer as single-chip."""
    A, _ = problems.sym_grid_laplacian((16, 16))
    A = sp.csr_from_dense(-np.asarray(A.todense()))
    rhs = np.random.default_rng(7).standard_normal(256)
    x_local, info_local = sp.cg(A.to_dia(), jnp.asarray(rhs), tol=1e-12, max_iter=2000)
    info_local.raise_if_error()
    x, info = distributed_solve(sp.cg, A.to_dia(), rhs, tol=1e-12, max_iter=2000)
    info.raise_if_error()
    r = np.asarray(A.matvec(x)) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-10
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_local), atol=1e-8)


def test_distributed_gmres():
    """GMRES's psum'd CGS2 Arnoldi reductions under shard_map: the Krylov
    basis (n, m) shards with the rows; restarts must converge to the
    single-chip answer on a nonsymmetric system."""
    A, rhs = _dirichlet((16, 16))
    from functools import partial

    gmres16 = partial(sp.gmres, restart=16)
    x, info = distributed_solve(gmres16, A.to_dia(), rhs, tol=1e-12, max_iter=600)
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x, jnp.float64))) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-10


def test_distributed_idrs():
    """IDR(s)'s shadow projections psum under shard_map (a replicated local
    shadow block is still a valid global shadow space)."""
    A, rhs = _dirichlet((16, 16))
    x, info = distributed_solve(sp.idrs, A.to_dia(), rhs, tol=1e-12,
                                max_iter=2000)
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x, jnp.float64))) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-10
