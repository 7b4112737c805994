"""CGS: conjugate-gradient-squared for general nonsymmetric systems.

Beyond the reference's surface (its nonsymmetric solver is BiCGStab,
``src/bicg_stab.rs`` — historically CGS's smoothed successor): CGS
(Sonneveld, 1989) squares the BiCG residual polynomial, Φ²ᵢ(A)r₀, so it is
transpose-free and converges roughly twice as fast as BiCG per matvec when
it converges — at the price of the famously erratic residual history that
BiCGStab was invented to smooth.  Kept in the suite because it is part of
the standard ``scipy.sparse.linalg`` family and occasionally beats
BiCGStab on matvec count.

Structure per iteration (Templates, §2.3.7): two SpMVs, two M⁻¹ applies,
two shadow inner products, with BOTH preconditioner applications folded
into vector updates so x is tracked directly (no y-space drift).
Breakdown: ρ = r̃ᴴr or σ = r̃ᴴv can vanish without convergence; both are
predicated ``Status.BREAKDOWN`` exits against the same ε²-scaled
thresholds BiCGStab uses for ρ (``src/bicg_stab.rs:84-85``).

Shape: one ``lax.while_loop`` with the state pytree as workspace —
identical discipline to :func:`~sprsolve_tpu.solvers.bicgstab`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..ops.operator import IdentityOperator
from ..vecalg import axpy, conj_dot, eps_for, norm2
from .common import check_shapes, make_info


class _State(NamedTuple):
    x: jax.Array
    r: jax.Array
    p: jax.Array
    q: jax.Array
    rho_prev: jax.Array  # T scalar: r̃ᴴr of the previous iteration
    r_norm: jax.Array    # real: ‖r‖₂ of the carried r
    its: jax.Array
    status: jax.Array
    res: jax.Array
    hist: jax.Array


def cgs(
    A,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    M=None,
    tol,
    max_iter,
    axis_name: Optional[str] = None,
    record_residuals: bool = False,
):
    """Solve general A·x = b with CGS. Returns ``(x, SolveInfo)``.

    ``M`` applies M⁻¹ (any of this package's preconditioners).  The
    convergence test is the true recurrence residual ‖r‖/‖b‖, like the
    reference's Krylov solvers.  ``record_residuals=True`` (static
    ``max_iter``) adds the per-iteration relative-residual trace as a
    third output — expect it to be non-monotone; that is CGS.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    if M is None:
        M = IdentityOperator(b.shape[0])

    T = b.dtype
    rdt = jnp.finfo(T).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    # +1: the final write lands at hist[its] with its == max_iter when
    # convergence hits exactly at the budget
    hist_len = int(max_iter) + 1 if record_residuals else 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(b.dtype)
    one_t = jnp.ones((), T)

    def main(rhs_norm):
        tol2 = tol * rhs_norm

        r = axpy(-one_t, A.matvec(x0), b)  # r = b − A·x
        r_norm0 = norm2(r, axis_name)
        rt = r                              # shadow residual r̃ = r₀

        def early(_):
            hist = jnp.full(hist_len, jnp.nan, dtype=rdt)
            if hist_len:
                hist = hist.at[0].set(r_norm0 / rhs_norm)
            return x0, make_info(0, r_norm0 / rhs_norm, Status.CONVERGED), hist

        def iterate(_):
            brk_tol = (r_norm0 * eps) ** 2

            # q = p = 0 makes the first body iteration produce u = r,
            # p = u regardless of β — the Templates i == 1 special case
            # without a branch
            st0 = _State(
                x=x0, r=r, p=jnp.zeros_like(r), q=jnp.zeros_like(r),
                rho_prev=one_t,
                r_norm=r_norm0,
                its=jnp.int32(0),
                status=jnp.int32(Status.RUNNING),
                res=jnp.zeros((), rdt),
                hist=jnp.full(hist_len, jnp.nan, dtype=rdt),
            )

            def cond_fn(s_):
                return (
                    (s_.status == Status.RUNNING)
                    & (s_.its < max_iter)
                    & (s_.r_norm > tol2)
                )

            def body_fn(s_):
                if hist_len:
                    s_ = s_._replace(
                        hist=s_.hist.at[s_.its].set(s_.r_norm / rhs_norm)
                    )
                rho = conj_dot(rt, s_.r, axis_name)
                ok_rho = jnp.abs(rho) > brk_tol
                beta = rho / jnp.where(ok_rho, s_.rho_prev, one_t)
                u = axpy(beta, s_.q, s_.r)
                p = axpy(beta, axpy(beta, s_.p, s_.q), u)
                v = A.matvec(M.matvec(p))
                sigma = conj_dot(rt, v, axis_name)
                ok = ok_rho & (jnp.abs(sigma) > brk_tol)
                alpha = rho / jnp.where(ok, sigma, one_t)
                q_new = axpy(-alpha, v, u)
                uh = M.matvec(u + q_new)
                x_new = axpy(alpha, uh, s_.x)
                r_new = axpy(-alpha, A.matvec(uh), s_.r)
                r_norm = norm2(r_new, axis_name)

                return _State(
                    x=jnp.where(ok, x_new, s_.x),
                    r=jnp.where(ok, r_new, s_.r),
                    p=jnp.where(ok, p, s_.p),
                    q=jnp.where(ok, q_new, s_.q),
                    rho_prev=jnp.where(ok, rho, s_.rho_prev),
                    r_norm=jnp.where(ok, r_norm, s_.r_norm),
                    its=jnp.where(ok, s_.its + 1, s_.its),
                    status=jnp.where(
                        ok, s_.status, jnp.int32(Status.BREAKDOWN)
                    ),
                    res=jnp.where(ok, s_.res, s_.r_norm / rhs_norm),
                    hist=s_.hist,
                )

            final = lax.while_loop(cond_fn, body_fn, st0)
            converged = (final.status == Status.RUNNING) & (
                final.r_norm <= tol2
            )
            status = jnp.where(
                converged,
                jnp.int32(Status.CONVERGED),
                jnp.where(
                    final.status == Status.RUNNING,
                    jnp.int32(Status.INSUFFICIENT_ITER),
                    final.status,
                ),
            )
            res = jnp.where(
                final.status == Status.RUNNING,
                final.r_norm / rhs_norm,
                final.res,
            )
            hist = final.hist
            if hist_len:
                hist = jnp.where(
                    converged,
                    hist.at[final.its].set(final.r_norm / rhs_norm),
                    hist,
                )
            return final.x, make_info(final.its, res, status), hist

        return lax.cond(r_norm0 <= tol2, early, iterate, None)

    from .bicgstab import _guard3

    x, info, hist = _guard3(b, x0, main, axis_name, hist_len, rdt)
    if record_residuals:
        return x, info, hist
    return x, info
