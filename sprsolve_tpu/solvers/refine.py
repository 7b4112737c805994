"""Mixed-precision iterative refinement: f64 accuracy from f32 inner solves.

The reference's fidelity bar is f64 (tolerances 1e-17,
``tests/test_solvers.rs:45``).  Classical iterative refinement reaches it
while the hot work runs in f32, which moves half the bytes of f64:

    x₀ = 0
    repeat:  r = b − A·x   (f64, one XLA SpMV per outer step)
             d ≈ A⁻¹ r     (f32 Krylov solve, the hot work)
             x ← x + d     (f64)

Whether this beats a direct f64 solve on a card with native f64 is not
measured yet (ROADMAP speed item 3).

Each outer step multiplies the error by O(κ(A)·ε_f32), so a handful of
steps reach f64 limits whenever κ(A) ≪ 1/ε_f32 ≈ 2·10⁷.  The entire
procedure is ONE jitted program (outer ``lax.while_loop`` whose body runs
the inner solver's while_loop), so dispatch latency is paid once, not per
refinement step.

The residual is normalized before the f32 cast (the inner system is always
solved at unit scale), so refinement proceeds to f64 machine epsilon
without f32 underflow.

Compile cost: the nested outer/inner while_loop program is the most
expensive compile in the package.  The ``refine_solve`` runners are
module-level jits keyed by the static configuration, so repeated solves
share the compiled executable.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import IncompatibleMatrixFormat, Status
from ..vecalg import eps_for, norm2
from .common import make_info


class _State(NamedTuple):
    x: jax.Array        # (n,) f64 iterate
    r: jax.Array        # (n,) f64 residual b − A·x (carried: one A64 apply
    #                     per outer step, matching the module docstring)
    r_norm: jax.Array   # f64 scalar ‖r‖
    outer: jax.Array
    stall: jax.Array    # consecutive weak-contraction steps (int32)
    status: jax.Array


def refine(
    A64,
    A32,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    inner=None,
    M=None,
    tol,
    max_refine: int = 20,
    inner_tol: float = 1e-5,
    inner_max_iter: int = 400,
):
    """Solve A·x = b to f64 accuracy using an f32 inner solver.

    ``A64`` is the f64 operator used for true residuals (one apply per outer
    step; any layout — the XLA DIA path is the natural choice).  ``A32`` is
    the f32 execution-layout operator for the inner solves (the operator
    from ``optimize()``; may expose ``pad_vec``).  ``inner``
    is a functional solver (default :func:`~sprsolve_tpu.solvers.bicgstab`);
    ``M`` preconditions the inner solve and must live in ``A32``'s layout.

    Returns ``(x, SolveInfo)`` where ``iterations`` counts *outer*
    refinement steps and ``residual`` is the true f64 relative residual.
    Stagnation (residual no longer contracting — κ(A)·ε_f32 ≳ 1) exits with
    ``Status.BREAKDOWN`` and the best iterate.
    """
    from .bicgstab import bicgstab

    if inner is None:
        inner = bicgstab
    if b.dtype != jnp.float64:
        raise IncompatibleMatrixFormat(
            "refine() is the f64-accuracy driver; b must be float64 "
            "(enable jax_enable_x64)"
        )
    n = b.shape[0]
    if x0 is None:
        x0 = jnp.zeros_like(b)

    padded = hasattr(A32, "pad_vec")
    tol = jnp.asarray(tol, jnp.float64)
    eps = eps_for(jnp.float64)
    inner_run = partial(inner, M=M, tol=inner_tol, max_iter=inner_max_iter) \
        if M is not None else partial(inner, tol=inner_tol,
                                      max_iter=inner_max_iter)

    def correction(r64, r_norm):
        # unit-scale the residual before the f32 cast (no underflow), solve
        # in the f32 execution layout, un-scale in f64
        r32 = (r64 / r_norm).astype(jnp.float32)
        if padded:
            r32 = A32.pad_vec(r32)
        d32, info = inner_run(A32, r32)
        if padded:
            d32 = A32.unpad_vec(d32)
        return d32.astype(jnp.float64) * r_norm, info.iterations

    def main(rhs_norm):
        tol_abs = tol * rhs_norm

        r0 = b - A64.matvec(x0)
        st = _State(
            x=x0,
            r=r0,
            r_norm=norm2(r0),
            outer=jnp.int32(0),
            stall=jnp.int32(0),
            status=jnp.int32(Status.RUNNING),
        )

        def cond_fn(s_):
            return (
                (s_.status == Status.RUNNING)
                & (s_.outer < max_refine)
                & (s_.r_norm > tol_abs)
            )

        def body_fn(s_):
            d64, _ = correction(s_.r, s_.r_norm)
            x = s_.x + d64
            r_vec = b - A64.matvec(x)  # the step's single A64 apply
            r_new = norm2(r_vec)
            # stagnation: refinement must contract; κ·ε_f32 too large if not.
            # A kept-but-weak step (factor in (0.5, 1)) may be a loose inner
            # solve near the f32 floor — give it one more chance; a fully
            # REJECTED step would retry from identical state and get the
            # identical result, so it breaks down immediately.
            improved = r_new < s_.r_norm * jnp.float64(0.5)
            keep = r_new < s_.r_norm  # accept any improvement
            stall = jnp.where(improved, jnp.int32(0), s_.stall + 1)
            broke = (stall >= 2) | ~keep
            return _State(
                x=jnp.where(keep, x, s_.x),
                r=jnp.where(keep, r_vec, s_.r),
                r_norm=jnp.where(keep, r_new, s_.r_norm),
                outer=s_.outer + 1,
                stall=stall,
                status=jnp.where(
                    broke, jnp.int32(Status.BREAKDOWN), s_.status
                ),
            )

        final = lax.while_loop(cond_fn, body_fn, st)
        converged = final.r_norm <= tol_abs
        status = jnp.where(
            converged,
            jnp.int32(Status.CONVERGED),
            jnp.where(
                final.status == Status.RUNNING,
                jnp.int32(Status.INSUFFICIENT_ITER),
                final.status,
            ),
        )
        return final.x, make_info(final.outer, final.r_norm / rhs_norm, status)

    rhs_norm = norm2(b)

    def trivial(_):
        return jnp.zeros_like(b), make_info(0, rhs_norm, Status.CONVERGED)

    return lax.cond(rhs_norm <= eps, trivial, lambda _: main(rhs_norm), None)


def refine_solve(
    A,
    b,
    *,
    inner: str = "bicgstab",
    M=None,
    tol: float = 1e-12,
    max_refine: int = 20,
    inner_tol: float = 1e-5,
    inner_max_iter: int = 400,
    x0=None,
):
    """Convenience wrapper: build both precisions from a host CSR and run
    :func:`refine` under one jit.

    ``A`` is an f64 CSR; the f64 residual operator is its DIA/XLA form and
    the f32 inner operator comes from ``optimize()``.  ``M`` may be
    ``"jacobi"`` (built in the inner layout) or a
    preconditioner living in the inner operator's layout.
    """
    import numpy as np

    from . import bicgstab, cg, gmres, minres
    from ..ops.optimize import optimize
    from ..sparse.containers import CSR

    if not isinstance(A, CSR):
        raise IncompatibleMatrixFormat("refine_solve needs a host CSR")
    if np.iscomplexobj(np.asarray(A.data)):
        return _refine_solve_complex(
            A, b, inner=inner, M=M, tol=tol, max_refine=max_refine,
            inner_tol=inner_tol, inner_max_iter=inner_max_iter, x0=x0,
        )
    solvers = {"bicgstab": bicgstab, "cg": cg, "minres": minres,
               "gmres": gmres}
    if inner not in solvers:
        raise IncompatibleMatrixFormat(
            f"refine inner solver must be one of {sorted(solvers)} for real "
            f"systems (got {inner!r})"
        )
    inner_fn = solvers[inner]
    data64 = np.asarray(A.data, np.float64)
    csr64 = CSR.from_arrays(data64, A.indices, A.indptr, A.shape)
    try:
        A64 = csr64.to_dia()
    except ValueError:  # > 64 distinct diagonals: residuals via the CSR path
        A64 = csr64
    A32 = optimize(
        CSR.from_arrays(data64.astype(np.float32), A.indices, A.indptr,
                        A.shape)
    )
    if isinstance(M, str):
        if M != "jacobi":
            raise IncompatibleMatrixFormat(
                "refine_solve supports M='jacobi' or a prebuilt "
                "inner-layout preconditioner"
            )
        if hasattr(A32, "jacobi_precond"):
            M = A32.jacobi_precond()
        else:
            from ..precond import DiagPrecond

            M = DiagPrecond.new(A32.diagonal())
    b = jnp.asarray(b, jnp.float64)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, jnp.float64)
    if _m_traceable(M):
        return _jit_refine(
            A64, A32, b, x0, M,
            inner=inner_fn, tol=tol, max_refine=max_refine,
            inner_tol=inner_tol, inner_max_iter=inner_max_iter,
        )
    # custom (non-pytree) preconditioner: closure capture, uncached jit —
    # the pre-cache behavior
    run = jax.jit(lambda a64, a32, bb, xx0: refine(
        a64, a32, bb, xx0, inner=inner_fn, M=M, tol=tol,
        max_refine=max_refine, inner_tol=inner_tol,
        inner_max_iter=inner_max_iter,
    ))
    return run(A64, A32, b, x0)


class _PlanesDIA(NamedTuple):
    """f64 complex operator as real re/im DIA planes: A·x with
    x = (xr, xi) is four real XLA-DIA applies."""

    re: object
    im: object

    def apply(self, xr, xi):
        ar = self.re.matvec(xr) - self.im.matvec(xi)
        ai = self.re.matvec(xi) + self.im.matvec(xr)
        return ar, ai


def refine_complex(
    A64: _PlanesDIA,
    A32,
    b_re: jax.Array,
    b_im: jax.Array,
    x0_re: Optional[jax.Array] = None,
    x0_im: Optional[jax.Array] = None,
    *,
    inner=None,
    M=None,
    tol,
    max_refine: int = 20,
    inner_tol: float = 1e-5,
    inner_max_iter: int = 500,
):
    """Complex counterpart of :func:`refine`: c128 accuracy from a c64 inner
    solve, with the right-hand side and the iterate passed as f64 re/im
    planes.

    ``A64`` is a :class:`_PlanesDIA` of f64 re/im DIA operators (the true-
    residual apply); ``A32`` a c64 operator for the inner solves (e.g. a
    complex :class:`~sprsolve_tpu.sparse.containers.DIA`); ``inner`` a
    complex-capable solver (default ``cs_minres`` — use ``bicgstab`` for
    non-symmetric complex systems).  Returns ``(x_re, x_im, SolveInfo)``.
    """
    from .cs_minres import cs_minres

    if inner is None:
        inner = cs_minres
    if b_re.dtype != jnp.float64:
        raise IncompatibleMatrixFormat(
            "refine_complex is the c128-accuracy driver; planes must be "
            "float64 (enable jax_enable_x64)"
        )
    if x0_re is None:
        x0_re = jnp.zeros_like(b_re)
    if x0_im is None:
        x0_im = jnp.zeros_like(b_im)

    padded = hasattr(A32, "pad_vec")
    tol = jnp.asarray(tol, jnp.float64)
    eps = eps_for(jnp.float64)
    kwargs = dict(tol=inner_tol, max_iter=inner_max_iter)
    if M is not None:
        kwargs["M"] = M
    inner_c = partial(inner, **kwargs)

    def inner_run(A, br, bi):
        x, info = inner_c(A, br + 1j * bi)
        return jnp.real(x), jnp.imag(x), info

    def norm_pl(vr, vi):
        return jnp.sqrt(norm2(vr) ** 2 + norm2(vi) ** 2)

    def residual(xr, xi):
        ar, ai = A64.apply(xr, xi)
        return b_re - ar, b_im - ai

    def correction(rr, ri, r_norm):
        rr32 = (rr / r_norm).astype(jnp.float32)
        ri32 = (ri / r_norm).astype(jnp.float32)
        if padded:
            rr32, ri32 = A32.pad_vec(rr32), A32.pad_vec(ri32)
        dr, di, info = inner_run(A32, rr32, ri32)
        if padded:
            dr, di = A32.unpad_vec(dr), A32.unpad_vec(di)
        return (dr.astype(jnp.float64) * r_norm,
                di.astype(jnp.float64) * r_norm, info.iterations)

    class _CState(NamedTuple):
        xr: jax.Array
        xi: jax.Array
        rr: jax.Array
        ri: jax.Array
        r_norm: jax.Array
        outer: jax.Array
        stall: jax.Array
        status: jax.Array

    def main(rhs_norm):
        tol_abs = tol * rhs_norm
        r0r, r0i = residual(x0_re, x0_im)
        st = _CState(
            xr=x0_re, xi=x0_im, rr=r0r, ri=r0i,
            r_norm=norm_pl(r0r, r0i),
            outer=jnp.int32(0),
            stall=jnp.int32(0),
            status=jnp.int32(Status.RUNNING),
        )

        def cond_fn(s_):
            return (
                (s_.status == Status.RUNNING)
                & (s_.outer < max_refine)
                & (s_.r_norm > tol_abs)
            )

        def body_fn(s_):
            dr, di, _ = correction(s_.rr, s_.ri, s_.r_norm)
            xr, xi = s_.xr + dr, s_.xi + di
            rr_new, ri_new = residual(xr, xi)  # the step's single apply
            r_new = norm_pl(rr_new, ri_new)
            # same two-consecutive-weak-steps stagnation rule as refine()
            improved = r_new < s_.r_norm * jnp.float64(0.5)
            keep = r_new < s_.r_norm
            stall = jnp.where(improved, jnp.int32(0), s_.stall + 1)
            # same rule as refine(): one-step grace only for kept-but-weak
            broke = (stall >= 2) | ~keep
            return _CState(
                xr=jnp.where(keep, xr, s_.xr),
                xi=jnp.where(keep, xi, s_.xi),
                rr=jnp.where(keep, rr_new, s_.rr),
                ri=jnp.where(keep, ri_new, s_.ri),
                r_norm=jnp.where(keep, r_new, s_.r_norm),
                outer=s_.outer + 1,
                stall=stall,
                status=jnp.where(
                    broke, jnp.int32(Status.BREAKDOWN), s_.status
                ),
            )

        final = lax.while_loop(cond_fn, body_fn, st)
        converged = final.r_norm <= tol_abs
        status = jnp.where(
            converged,
            jnp.int32(Status.CONVERGED),
            jnp.where(
                final.status == Status.RUNNING,
                jnp.int32(Status.INSUFFICIENT_ITER),
                final.status,
            ),
        )
        return (final.xr, final.xi,
                make_info(final.outer, final.r_norm / rhs_norm, status))

    rhs_norm = norm_pl(b_re, b_im)

    def trivial(_):
        return (jnp.zeros_like(b_re), jnp.zeros_like(b_im),
                make_info(0, rhs_norm, Status.CONVERGED))

    return lax.cond(rhs_norm <= eps, trivial, lambda _: main(rhs_norm), None)


def _refine_solve_complex(A, b, *, inner, M, tol, max_refine, inner_tol,
                          inner_max_iter, x0):
    """Complex branch of :func:`refine_solve`: c128 accuracy via
    :func:`refine_complex` (c64 inner solves)."""
    import numpy as np

    from . import bicgstab, cocg, cs_minres
    from ..sparse.containers import CSR

    solvers = {"cs_minres": cs_minres, "bicgstab": bicgstab, "cocg": cocg}
    if inner not in solvers:
        raise IncompatibleMatrixFormat(
            "refine inner solver must be 'cocg', 'cs_minres' or 'bicgstab' "
            f"for complex systems (got {inner!r})"
        )
    inner_fn = solvers[inner]
    data = np.asarray(A.data, np.complex128)
    re64_csr = CSR.from_arrays(data.real, A.indices, A.indptr, A.shape)
    im64_csr = CSR.from_arrays(data.imag, A.indices, A.indptr, A.shape)
    try:
        A64 = _PlanesDIA(re=re64_csr.to_dia(), im=im64_csr.to_dia())
    except ValueError:  # > 64 diagonals: residual planes via the CSR path
        A64 = _PlanesDIA(re=re64_csr, im=im64_csr)
    A32 = _complex_inner_operator(A, data)
    if isinstance(M, str):
        if M != "jacobi":
            raise IncompatibleMatrixFormat(
                "refine_solve supports M='jacobi' or a prebuilt "
                "inner-layout preconditioner"
            )
        if inner == "cs_minres":
            # the preconditioned Saunders process needs a REAL symmetric-
            # positive M⁻¹: 1/|d| (see solvers/cs_minres.py docstring)
            from ..precond import real_abs_jacobi

            M = real_abs_jacobi(A32)
        elif hasattr(A32, "jacobi_precond"):
            M = A32.jacobi_precond()
        else:
            from ..precond import DiagPrecond

            M = DiagPrecond.new(A32.diagonal())
    b = np.asarray(b, np.complex128)
    x0 = np.zeros_like(b) if x0 is None else np.asarray(x0, np.complex128)
    args = (A64, A32, jnp.asarray(b.real), jnp.asarray(b.imag),
            jnp.asarray(x0.real), jnp.asarray(x0.imag))
    if _m_traceable(M):
        xr, xi, info = _jit_refine_complex(
            *args, M,
            inner=inner_fn, tol=tol, max_refine=max_refine,
            inner_tol=inner_tol, inner_max_iter=inner_max_iter,
        )
    else:
        run = jax.jit(lambda a64, a32, br, bi, xr0, xi0: refine_complex(
            a64, a32, br, bi, xr0, xi0, inner=inner_fn, M=M, tol=tol,
            max_refine=max_refine, inner_tol=inner_tol,
            inner_max_iter=inner_max_iter,
        ))
        xr, xi, info = run(*args)
    return np.asarray(xr) + 1j * np.asarray(xi), info


def _complex_inner_operator(A, data):
    """Pick the c64 execution-layout operator for complex refinement via
    ``optimize()``: DIA when banded, else the two-plane
    :class:`~sprsolve_tpu.sparse.bsr.ComplexBSR` (or an RCM-banded layout)
    — the c/z arbitrary-CSR role of the reference's MKL backend
    (``src/mkl_mat.rs:32-74``).  CSR planes remain only as the last resort
    when no block structure fits the memory budget.
    """
    import numpy as np

    from ..ops.optimize import optimize as _optimize
    from ..sparse.containers import CSR, ELL as _ELL

    c64 = CSR.from_arrays(
        data.astype(np.complex64), A.indices, A.indptr, A.shape
    )
    A32 = _optimize(c64)
    if isinstance(A32, _ELL) or isinstance(getattr(A32, "inner", None), _ELL):
        A32 = _PlanesComplexOp(
            re=CSR.from_arrays(data.real.astype(np.float32), A.indices,
                               A.indptr, A.shape),
            im=CSR.from_arrays(data.imag.astype(np.float32), A.indices,
                               A.indptr, A.shape),
        )
    return A32


class _PlanesComplexOp(NamedTuple):
    """c64 operator as real f32 re/im CSR planes — the non-banded fallback
    for complex inner solves (real leaves cross the jit boundary; the
    complex view exists only inside the compiled program)."""

    re: object
    im: object

    @property
    def shape(self):
        return self.re.shape

    def matvec(self, x: jax.Array) -> jax.Array:
        xr, xi = jnp.real(x), jnp.imag(x)
        return (self.re.matvec(xr) - self.im.matvec(xi)) + 1j * (
            self.re.matvec(xi) + self.im.matvec(xr)
        )

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def jacobi_precond(self):
        from ..precond import ComplexDiagPrecond
        import numpy as np

        d = np.asarray(self.re.diagonal()) + 1j * np.asarray(
            self.im.diagonal()
        )
        return ComplexDiagPrecond.new(d)


def _m_traceable(M) -> bool:
    """True when M can cross the jit boundary as a traced pytree argument
    (None, or every leaf an array). Custom host objects with ``matvec`` fall
    back to closure capture (no cross-call compile cache)."""
    import numpy as np

    if M is None:
        return True
    try:
        leaves = jax.tree_util.tree_leaves(M)
    except Exception:
        return False
    return all(isinstance(l, (jax.Array, np.ndarray, float, int)) for l in leaves)


# module-level jitted runners so repeated refine_solve calls with the same
# configuration share the compile cache (a fresh jitted lambda per call
# would re-trace every time — the nested outer/inner while_loop program is
# the most expensive compile in the package)
@partial(
    jax.jit,
    static_argnames=("inner", "tol", "max_refine", "inner_tol",
                     "inner_max_iter"),
)
def _jit_refine(a64, a32, b, x0, M, *, inner, tol, max_refine, inner_tol,
                inner_max_iter):
    return refine(
        a64, a32, b, x0, inner=inner, M=M, tol=tol, max_refine=max_refine,
        inner_tol=inner_tol, inner_max_iter=inner_max_iter,
    )


@partial(
    jax.jit,
    static_argnames=("inner", "tol", "max_refine", "inner_tol",
                     "inner_max_iter"),
)
def _jit_refine_complex(a64, a32, br, bi, xr0, xi0, M, *, inner, tol,
                        max_refine, inner_tol, inner_max_iter):
    return refine_complex(
        a64, a32, br, bi, xr0, xi0, inner=inner, M=M, tol=tol,
        max_refine=max_refine, inner_tol=inner_tol,
        inner_max_iter=inner_max_iter,
    )
