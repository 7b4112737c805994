"""HaloDIA: the distributed banded path — per-shard XLA DIA with ppermute
halo exchange — on the virtual 8-device mesh, against single-device
oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import sprsolve_tpu as sp
from sprsolve_tpu.parallel import distributed_solve, partition_dia
from sprsolve_tpu.utils import problems


def _shard(op, fn, out_specs, *vecs):
    mesh = jax.make_mesh((8,), ("rows",))
    with jax.set_mesh(mesh):
        return jax.shard_map(
            fn, mesh=mesh,
            in_specs=(op.pspec(),) + (P("rows"),) * len(vecs),
            out_specs=out_specs, check_vma=False,
        )(op, *vecs)


def test_dist_spmv_matches_local():
    A = problems.poisson3d(12, 12, 12, dtype=np.float64)  # 1728 rows, offsets ±144
    op = partition_dia(A.to_dia(), 8)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(A.shape[0]))
    want = np.asarray(A.matvec(x))
    y = _shard(op, lambda o, v: o.matvec(v), P("rows"), x)
    np.testing.assert_allclose(np.asarray(jax.device_get(y)), want,
                               rtol=1e-13, atol=1e-13)


def test_dist_pallas_bicgstab():
    A = problems.poisson3d(10, 10, 10, dtype=np.float64)
    dia = A.to_dia()
    b = np.random.default_rng(1).standard_normal(1000)
    M = sp.DiagPrecond.new(np.asarray(dia.diagonal()))
    x, info = distributed_solve(
        sp.bicgstab, dia, jnp.asarray(b), M=M, tol=1e-12, max_iter=500
    )
    info.raise_if_error()
    assert x.shape == (1000,)
    r = np.asarray(A.matvec(x)) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_dist_matvec_dot_fused_partials():
    """matvec_dot returns per-shard partials of conj(x)·(A·x) whose psum
    equals the serial dot (the mkl_sparse_?_dotmv analog, distributed)."""
    A = problems.poisson3d(12, 12, 12, dtype=np.float64)
    op = partition_dia(A.to_dia(), 8)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(A.shape[0]))
    y_want = np.asarray(A.matvec(x))

    def f(o, v):
        y, d = o.matvec_dot(v)
        return y, jax.lax.psum(d, "rows")

    y, dot = _shard(op, f, (P("rows"), P()), x)
    np.testing.assert_allclose(np.asarray(jax.device_get(y)), y_want, rtol=1e-13)
    np.testing.assert_allclose(float(dot), float(np.asarray(x) @ y_want),
                               rtol=1e-12)


def test_dist_minres_fused_orth_matches_single_chip():
    A = problems.poisson3d(10, 10, 10, dtype=np.float64)
    b = np.random.default_rng(3).standard_normal(1000)
    x_d, info_d = distributed_solve(
        sp.minres, A.to_dia(), jnp.asarray(b), tol=1e-10, max_iter=400
    )
    info_d.raise_if_error()
    r = np.asarray(A.matvec(x_d)) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8
    x_s, info_s = sp.minres(A.to_dia(), jnp.asarray(b), tol=1e-10, max_iter=400)
    info_s.raise_if_error()
    assert abs(int(info_d.iterations) - int(info_s.iterations)) <= max(
        3, int(info_s.iterations) // 10
    )


def test_halo_too_wide_rejected():
    A = problems.poisson3d(12, 12, 12, dtype=np.float64)
    with pytest.raises(ValueError):
        # offsets ±144 need at least 144 rows per device
        partition_dia(A.to_dia(), 64)


def test_distributed_bicgstab_jacobi_composed_prec():
    """f32 system with a DiagPrecond sharded with the rows: the M apply and
    the SpMV compose with one halo exchange per SpMV."""
    A = problems.grid_laplacian_dirichlet((16, 16), dtype=np.float32)
    rhs = np.zeros(256, dtype=np.float32)
    problems.set_boundary_condition(rhs, (16, 16), lambda r, c: np.float32(r + c))
    M = sp.DiagPrecond.new(np.asarray(A.diagonal()))
    x, info = distributed_solve(
        sp.bicgstab, A.to_dia(), jnp.asarray(rhs), M=M, tol=1e-5, max_iter=500
    )
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x))) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-4
