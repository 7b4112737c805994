"""Narrow exact band storage (``DIA.narrow``) and the SpMV+dot helpers that
BiCGStab's reductions go through.

Narrowing must be lossless by construction: any band set that does not
round-trip exactly stays f32, and a narrowed operator must produce
bit-identical results to the f32-stored one (the bands are widened inside
the fused pass before the multiply)."""

import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.ops.operator import mv_prec_wdot, mv_wdot2
from sprsolve_tpu.sparse.containers import DIA
from sprsolve_tpu.utils import problems
from sprsolve_tpu.vecalg import conj_dot


def _rand_x(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(n).astype(dtype))


def test_narrow_detection_tiers():
    A = problems.poisson3d(8, 8, 8, dtype=np.float32)
    dia = A.to_dia()
    # integer bands in [-128, 127] → int8
    assert dia.narrow().bands.dtype == jnp.int8
    # 2.5 is exact in bfloat16 but not an integer → bf16
    b25 = DIA(bands=np.asarray(dia.bands) * np.float32(2.5),
              offsets=dia.offsets, shape=dia.shape)
    assert b25.narrow().bands.dtype == jnp.bfloat16
    # 1/3 rounds in bf16 → stays f32 (the same object)
    b3 = DIA(bands=np.asarray(dia.bands) / np.float32(3.0),
             offsets=dia.offsets, shape=dia.shape)
    assert b3.narrow() is b3
    # f64 and complex bands are never narrowed
    d64 = problems.poisson3d(4, 4, 4, dtype=np.float64).to_dia()
    assert d64.narrow() is d64
    dc = DIA(bands=np.asarray(dia.bands).astype(np.complex64),
             offsets=dia.offsets, shape=dia.shape)
    assert dc.narrow() is dc


def test_narrow_matvec_bit_identical():
    A = problems.poisson3d(8, 8, 8, dtype=np.float32)
    d_f32 = A.to_dia()
    d_narrow = d_f32.narrow()
    assert d_narrow.dtype == jnp.float32  # compute dtype unchanged
    x = _rand_x(512, 0)
    np.testing.assert_array_equal(
        np.asarray(d_narrow.matvec(x)), np.asarray(d_f32.matvec(x))
    )
    y_n, d_n = d_narrow.matvec_dot(x)
    y_f, d_f = d_f32.matvec_dot(x)
    np.testing.assert_array_equal(np.asarray(y_n), np.asarray(y_f))
    assert float(d_n) == float(d_f)
    X = jnp.stack([x, 2 * x], axis=1)
    np.testing.assert_array_equal(
        np.asarray(d_narrow.matmat(X)), np.asarray(d_f32.matmat(X))
    )


def test_narrow_jacobi_diagonal_widened():
    A = problems.poisson3d(6, 6, 6, dtype=np.float32)
    op = sp.optimize(A)
    d = op.diagonal()
    assert op.bands.dtype == jnp.int8 and d.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(d), 6.0)
    x, info = sp.solve(A, np.ones(216, np.float32), M="jacobi", tol=1e-6)
    info.raise_if_error()
    assert x.dtype == jnp.float32


def test_matvec_wdot_matches_unfused():
    op = sp.optimize(problems.poisson3d(10, 10, 10, dtype=np.float32))
    x, w = _rand_x(1000, 1), _rand_x(1000, 2)
    y, wd, yd = mv_wdot2(op, x, w)
    y_ref = op.matvec(x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), rtol=1e-6)
    np.testing.assert_allclose(float(wd), float(jnp.vdot(w, y_ref)), rtol=1e-4)
    np.testing.assert_allclose(float(yd), float(jnp.vdot(y_ref, y_ref)), rtol=1e-4)


def test_mv_wdot_generic_fallback():
    """The compose path keeps its semantics on any operator (conj-linear in
    w, c128 included)."""
    from sprsolve_tpu.ops.operator import mv_wdot

    A, rhs, _ = problems.hermitian_grid_with_diag((6, 6))
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(36) + 1j * rng.standard_normal(36))
    w = jnp.asarray(rng.standard_normal(36) - 1j * rng.standard_normal(36))
    y, wd = mv_wdot(A, x, w)
    y2, wd2, yd2 = mv_wdot2(A, x, w)
    y_ref = A.matvec(x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), rtol=1e-13)
    np.testing.assert_allclose(complex(wd), complex(jnp.vdot(w, y_ref)), rtol=1e-12)
    np.testing.assert_allclose(complex(wd2), complex(wd), rtol=1e-15)
    np.testing.assert_allclose(
        complex(yd2), complex(jnp.vdot(y_ref, y_ref)), rtol=1e-12
    )


def test_bicgstab_degenerate_system_never_false_converges():
    """On a nilpotent system r0·v hits exactly 0 in the *unrolled first
    iteration* (which, like the reference's src/bicg_stab.rs:87-120, is
    unguarded — the BreakDown check only exists in the main loop). The
    predicated loop must then terminate without claiming convergence."""
    from sprsolve_tpu.errors import Status
    from sprsolve_tpu.ops.operator import as_operator

    A = as_operator(jnp.asarray(np.array([[0.0, 0.0], [1.0, 0.0]])))
    b = jnp.asarray(np.array([1.0, 0.0]))
    x, info = sp.bicgstab(A, b, tol=1e-30, max_iter=50)
    assert int(info.status) != int(Status.CONVERGED)


def test_wdot_prec_matches_composed():
    """mv_prec_wdot == (M⁻¹x, A·M⁻¹x, conj(w)·A·M⁻¹x) on a narrow DIA."""
    A = problems.poisson3d(8, 8, 8, dtype=np.float32)
    op = sp.optimize(A)
    x, w = _rand_x(512, 0), _rand_x(512, 5)
    M = sp.DiagPrecond.new(op.diagonal())
    u, y_f, wd_f = mv_prec_wdot(op, M, x, w)
    u_c = x * M.diag_inv
    y_c = op.matvec(u_c)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u_c))
    np.testing.assert_allclose(np.asarray(y_f), np.asarray(y_c), rtol=2e-5,
                               atol=2e-6)
    assert abs(float(wd_f) - float(jnp.sum(w * y_c))) < 1e-2


def test_bicgstab_jacobi_padded_fused_converges():
    A = problems.poisson3d(8, 8, 8, dtype=np.float32)
    op = sp.optimize(A)
    b = _rand_x(512, 1)
    x, info = sp.bicgstab(op, b, M=sp.DiagPrecond.new(op.diagonal()),
                          tol=1e-5, max_iter=500)
    info.raise_if_error()
    r = np.asarray(A.matvec(np.asarray(x, np.float64))) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-4


def _complex_op(seed=0, side=12):
    A, rhs, _ = problems.complex_symmetric_grid_with_diag(
        (side, side), dtype=np.complex64
    )
    op = sp.optimize(A)
    assert isinstance(op, DIA) and op.dtype == jnp.complex64
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    mk = lambda: jnp.asarray(
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    )
    return A, op, mk(), mk()


def test_complex_wdot_matches_unfused():
    """conj(w)·A·x and ‖A·x‖² of the SpMV+dots helper on c64 DIA match the
    composed matvec + conj_dot path (w = x included)."""
    A, op, x, w = _complex_op()
    y_ref = op.matvec(x)
    y, wd, yd = mv_wdot2(op, x, w)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(complex(wd), complex(conj_dot(w, y_ref)),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(complex(yd), complex(conj_dot(y_ref, y_ref)),
                               rtol=2e-4, atol=2e-3)
    y2, wd2, yd2 = mv_wdot2(op, x, x)
    np.testing.assert_allclose(complex(wd2), complex(conj_dot(x, y_ref)),
                               rtol=2e-4, atol=2e-3)


def test_complex_wdot_cprec_matches_composed():
    """Complex-Jacobi apply → matvec → dots through mv_prec_wdot."""
    from sprsolve_tpu.precond import ComplexDiagPrecond

    A, op, x, w = _complex_op(seed=3)
    M = ComplexDiagPrecond.new(np.asarray(op.diagonal()))
    u_ref = x * (M.inv_re + 1j * M.inv_im).astype(x.dtype)
    y_ref = op.matvec(u_ref)
    u, y, wd = mv_prec_wdot(op, M, x, w)
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(complex(wd), complex(conj_dot(w, y_ref)),
                               rtol=2e-4, atol=2e-3)


def test_complex_bicgstab_fused_prec_converges():
    """End-to-end: complex BiCGStab + ComplexDiagPrecond on c64 DIA converges
    to the manufactured solution."""
    from sprsolve_tpu.precond import ComplexDiagPrecond

    A, rhs, _ = problems.complex_symmetric_grid_with_diag(
        (8, 8), dtype=np.complex64
    )
    op = sp.optimize(A)
    M = ComplexDiagPrecond.new(np.asarray(op.diagonal()))
    x, info = sp.bicgstab(op, jnp.asarray(rhs.astype(np.complex64)), M=M,
                          tol=1e-5, max_iter=300)
    info.raise_if_error()
    x_known = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(x) - x_known).max() < 1e-3
