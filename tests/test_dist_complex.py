"""Distributed complex-banded solves: c64 bands in a HaloDIA (ppermute halo
exchange, psum'd dots) on the virtual CPU mesh, against single-process
oracles."""

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

import sprsolve_tpu as sp
from sprsolve_tpu.ops.operator import mv_conj_dot, mv_wdot2
from sprsolve_tpu.parallel import distributed_solve, partition_dia
from sprsolve_tpu.precond import ComplexDiagPrecond
from sprsolve_tpu.utils import problems


def _complex_banded(side=16):
    A, rhs, diag = problems.complex_symmetric_grid_with_diag(
        (side, side), dtype=np.complex64
    )
    return A, rhs.astype(np.complex64)


def _mesh(nd):
    return jax.make_mesh((nd,), ("rows",), devices=jax.devices()[:nd])


def _cvec(seed, n=256):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _run(op, fn, out_specs, *vecs, nd=4):
    mesh = _mesh(nd)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(op.pspec("rows"),) + (P("rows"),) * len(vecs),
        out_specs=out_specs, check_vma=False,
    ))(op, *vecs)


def test_dist_complex_matvec_matches_oracle():
    A, rhs = _complex_banded(16)
    op = partition_dia(A.to_dia(), 4)
    assert op.dtype == jnp.complex64
    x = _cvec(0)
    want = np.asarray(A.matvec(jnp.asarray(x)))
    got = _run(op, lambda o, v: o.matvec(v), P("rows"), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(jax.device_get(got)), want,
                               rtol=2e-4, atol=2e-4)


def test_dist_complex_fused_dots_match():
    A, rhs = _complex_banded(16)
    op = partition_dia(A.to_dia(), 4)
    x = _cvec(1)

    def fused(o, v):
        y, d = o.matvec_dot(v)
        z, dc = mv_conj_dot(o, v, "rows")
        return [y, lax.psum(d, "rows"), z, dc]

    y2, d, z2, dc = _run(op, fused, [P("rows"), P(), P("rows"), P()],
                         jnp.asarray(x))
    want_y = np.asarray(A.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(jax.device_get(y2)), want_y,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(complex(d), np.vdot(x, want_y), rtol=2e-4,
                               atol=2e-3)
    want_z = np.asarray(A.matvec(jnp.asarray(np.conj(x))))
    np.testing.assert_allclose(np.asarray(jax.device_get(z2)), want_z,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(complex(dc), np.vdot(x, want_z), rtol=2e-4,
                               atol=2e-3)


def test_distributed_complex_bicgstab_and_cs_minres():
    """End-to-end distributed complex solves: BiCGStab with the complex
    Jacobi and preconditioned CS-MINRES with the real |d| Jacobi, both
    through distributed_solve on 8 virtual devices."""
    A, rhs = _complex_banded(16)
    dia = A.to_dia()
    mesh = _mesh(8)
    dense = np.asarray(A.todense())
    d = np.asarray(dense.diagonal())

    x1, info1 = distributed_solve(
        sp.bicgstab, dia, jnp.asarray(rhs), M=ComplexDiagPrecond.new(d),
        tol=1e-5, max_iter=300, mesh=mesh,
    )
    info1.raise_if_error()
    r1 = dense @ np.asarray(x1) - rhs
    assert np.linalg.norm(r1) / np.linalg.norm(rhs) < 1e-4

    x2, info2 = distributed_solve(
        sp.cs_minres, dia, jnp.asarray(rhs),
        M=sp.DiagPrecond.new(np.abs(d).astype(np.float32)),
        tol=1e-5, max_iter=300, mesh=mesh,
    )
    info2.raise_if_error()
    r2 = dense @ np.asarray(x2) - rhs
    assert np.linalg.norm(r2) / np.linalg.norm(rhs) < 1e-4


def test_distributed_flat_complex_jacobi_is_relaid():
    """A flat (n,)-planes ComplexDiagPrecond (the natural host-side build)
    is padded to the row-padded layout by distributed_solve, with inert
    1+0i pad reciprocals (225 rows over 4 devices → 3 pad rows)."""
    A, rhs = _complex_banded(15)
    dense = np.asarray(A.todense())
    M_flat = ComplexDiagPrecond.new(np.asarray(dense.diagonal()))
    assert M_flat.inv_re.shape == (225,)
    x, info = distributed_solve(
        sp.bicgstab, A.to_dia(), jnp.asarray(rhs), M=M_flat,
        tol=1e-5, max_iter=300, mesh=_mesh(4),
    )
    info.raise_if_error()
    assert x.shape == (225,)
    r = dense @ np.asarray(x) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-4


def test_dist_complex_wdot_matches_composed():
    """BiCGStab's SpMV+dots helper under shard_map (psum'd dots) vs the
    composed single-device oracle, including w = x."""
    A, rhs = _complex_banded(16)
    op = partition_dia(A.to_dia(), 4)
    x, w = _cvec(0), _cvec(1)

    def fused(o, v, wv):
        y, wd, yd = mv_wdot2(o, v, wv, "rows")
        _, wd2, _ = mv_wdot2(o, v, v, "rows")
        return [y, wd, yd, wd2]

    y2d, wd, yd, wd_x = _run(op, fused, [P("rows"), P(), P(), P()],
                             jnp.asarray(x), jnp.asarray(w))
    want_y = np.asarray(A.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(jax.device_get(y2d)), want_y,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(complex(wd), np.vdot(w, want_y), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(complex(yd), np.vdot(want_y, want_y),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(complex(wd_x), np.vdot(x, want_y), rtol=2e-4,
                               atol=2e-3)
