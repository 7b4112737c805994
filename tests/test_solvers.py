"""Integration tests — port of ``tests/test_solvers.rs``: Gauss-Seidel on the
10×10 Dirichlet grid Laplacian with **eps = 0** (exact floating-point fixed
point), BiCGStab on the 20×20 at tol 1e-17, same matrices and tolerances.

Golden iteration counts are recorded for regression tracking; the reference's
own tests assert only convergence (SURVEY.md §4), but BASELINE.md makes
iteration-count stability an explicit goal.
"""

import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.utils import problems

GOLDEN_GS_ITERS = 296
# BiCGStab counts are sensitive to fp reduction order (non-symmetric Krylov);
# this golden is deterministic under the conftest config (cpu, 8 devices, x64)
# but may legitimately shift with XLA versions — re-baseline if it moves while
# the residual still meets tolerance.
GOLDEN_BICGSTAB_ITERS = 112


def _dirichlet_problem(shape):
    A = problems.grid_laplacian_dirichlet(shape)
    rhs = np.zeros(shape[0] * shape[1])
    problems.set_boundary_condition(rhs, shape, lambda r, c: float(r + c))
    return A, rhs


def test_gauss_seidel():
    # tests/test_solvers.rs:2-31 — eps=0.0 expects the exact fixed point,
    # reachable because the stencil diagonals (-4, 1) are powers of two.
    A, rhs = _dirichlet_problem((10, 10))
    x, (iters, res) = sp.GaussSeidel.new(A).solve(rhs, max_iter=300, eps=0.0)
    assert res == 0.0
    assert iters == GOLDEN_GS_ITERS
    r = np.asarray(A.matvec(x)) - rhs
    assert np.linalg.norm(r) == 0.0


def test_bicg_stab():
    # tests/test_solvers.rs:33-57
    A, rhs = _dirichlet_problem((20, 20))
    x, (iters, res) = sp.BiCGStab.new(A, 400).solve(rhs, max_iter=1500, tol=1e-17)
    assert res <= 1e-17
    assert iters == GOLDEN_BICGSTAB_ITERS
    r = np.asarray(A.matvec(x)) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-12


def test_bicgstab_warm_start():
    # x is an in/out argument in the reference (src/bicg_stab.rs:72-75): a
    # warm start from the exact solution converges immediately.
    A, rhs = _dirichlet_problem((10, 10))
    x, _ = sp.BiCGStab.new(A, 100).solve(rhs, max_iter=1500, tol=1e-15)
    # the incremental r drifts slightly from the true residual, so restart
    # with a looser tol: the r0-norm early-out (src/bicg_stab.rs:81-83) fires.
    x2, (iters2, res2) = sp.BiCGStab.new(A, 100).solve(
        rhs, x=x, max_iter=1500, tol=1e-12
    )
    assert iters2 == 0
    np.testing.assert_array_equal(np.asarray(x2), np.asarray(x))


def test_bicgstab_functional_api_jits():
    A, rhs = _dirichlet_problem((10, 10))
    import jax

    f = jax.jit(
        lambda A, b: sp.bicgstab(A, b, tol=1e-15, max_iter=500),
    )
    x, info = f(A, jnp.asarray(rhs))
    assert bool(info.converged)
    assert info.iterations.dtype == jnp.int32


def test_bicgstab_dia_and_ell_backends_converge():
    A, rhs = _dirichlet_problem((16, 16))
    b = jnp.asarray(rhs)
    for op in (A, A.to_ell(), A.to_dia()):
        x, info = sp.bicgstab(op, b, tol=1e-15, max_iter=1500)
        info.raise_if_error()
        r = np.asarray(A.matvec(x)) - rhs
        assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-12


def test_bicgstab_residual_history():
    A, rhs = _dirichlet_problem((10, 10))
    x, info, hist = sp.bicgstab(
        A, jnp.asarray(rhs), tol=1e-14, max_iter=200, record_residuals=True
    )
    info.raise_if_error()
    k = int(info.iterations)
    h = np.asarray(hist)
    assert h.shape == (201,)  # max_iter+1: hist[i] = residual after i iters
    assert np.all(np.isfinite(h[: k + 1]))       # recorded up to termination
    assert np.all(np.isnan(h[k + 1 :]))           # untouched beyond
    assert h[k] <= 1e-14                          # last recorded == converged check
    assert h[0] == 1.0                            # r0 = -b with x0=0 → rel res 1


def test_nested_restart_marker_covers_kernel_operators():
    """BiCGStab compiles its ρ-restart as a nested-loop exit for EVERY
    operator (no per-class marker any more): the restart-free iteration is
    an inner while_loop inside the outer restart loop, with no
    vector-carrying cond in the hot body."""
    import jax
    import numpy as np

    from sprsolve_tpu.ops.reordered import Reordered
    from sprsolve_tpu.sparse.containers import CSR, DIA, ELL
    from sprsolve_tpu.sparse.bsr import BSR, ComplexBSR

    for cls in (CSR, DIA, ELL, BSR, ComplexBSR, Reordered):
        assert not hasattr(cls, "_prefers_nested_restart"), cls

    A = problems.grid_laplacian_dirichlet((8, 8), dtype=np.float32)
    b = jnp.ones(64, jnp.float32)
    for op in (A.to_dia(), A, Reordered.wrap(A.to_dia(), np.arange(64))):
        text = str(jax.make_jaxpr(
            lambda a, v: sp.bicgstab(a, v, tol=1e-6, max_iter=50)
        )(op, b))
        assert text.count("while[") >= 2, type(op)
