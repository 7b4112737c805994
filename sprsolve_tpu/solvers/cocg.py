"""COCG: conjugate-orthogonal CG for complex-*symmetric* systems.

Beyond the reference's surface (its complex-symmetric solver is CS-MINRES,
``src/cs_minres.rs``): COCG (van der Vorst & Melissen, 1990) is the
standard cheap iteration for Aᵀ = A — CG with every Hermitian inner
product replaced by the unconjugated bilinear form xᵀy, under which a
complex-symmetric A is self-adjoint.  One SpMV per iteration (vs
BiCGStab's two and CS-MINRES's one-plus-heavier recurrence), short
recurrence, and — unlike the preconditioned Saunders process, which needs
a REAL symmetric-positive M — COCG admits any complex-*symmetric* M⁻¹
(the complex Jacobi diag(1/d) qualifies), preserving the bilinear
self-adjointness of M⁻¹A.

Breakdown: the bilinear form is indefinite, so ρ = rᵀz or pᵀAp can vanish
without convergence (the classic COCG hazard); both exits are predicated
``Status.BREAKDOWN`` checks against the same ε²-scaled thresholds BiCGStab
uses for ρ.  Convergence is tested on the true 2-norm ‖r‖/‖b‖ like the
reference's Krylov solvers.

Shape: identical to :func:`~sprsolve_tpu.solvers.cg` — one
``lax.while_loop`` with the state pytree as workspace; the SpMV is the
operator's native c64 apply, and the tail reductions (ρ' = rᵀz and ‖r‖²)
fuse into one XLA pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..ops.operator import IdentityOperator
from ..vecalg import abs2, axpy, dot, eps_for, norm2
from .common import check_shapes, make_info


def _mag(v):
    """|v| as sqrt(re²+im²); agrees with ``jnp.abs`` to 1 ulp."""
    return jnp.sqrt(abs2(v))


class _State(NamedTuple):
    x: jax.Array
    r: jax.Array
    z: jax.Array         # M⁻¹·r (z ≡ r when M is None)
    p: jax.Array
    rho: jax.Array       # rᵀz of the carried vectors (unconjugated)
    r_norm: jax.Array    # real: ‖r‖₂ of the carried r
    its: jax.Array
    status: jax.Array
    res: jax.Array
    hist: jax.Array


def cocg(
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
    """Solve complex-symmetric A·x = b with COCG. Returns ``(x, SolveInfo)``.

    ``M`` must apply a complex-*symmetric* M⁻¹ (e.g.
    :class:`~sprsolve_tpu.precond.ComplexDiagPrecond` or a real
    ``DiagPrecond``).  On a real symmetric system COCG reduces exactly
    to CG.  ``record_residuals=True`` (static ``max_iter``) adds the
    per-iteration relative-residual trace as a third output.
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

        r = axpy(-one_t, A.matvec(x0), b)   # r = b − A·x
        r_norm0 = norm2(r, axis_name)

        def early(_):
            hist = jnp.full(hist_len, jnp.nan, dtype=rdt)
            if hist_len:
                hist = hist.at[0].set(r_norm0 / rhs_norm)
            return x0, make_info(0, r_norm0 / rhs_norm, Status.CONVERGED), hist

        def iterate(_):
            z = M.matvec(r)
            rho = dot(r, z, axis_name)      # unconjugated bilinear form
            # breakdown thresholds at the problem's rounding floor, the
            # BiCGStab ρ-scale convention (src/bicg_stab.rs:84-85)
            brk_tol = (r_norm0 * eps) ** 2

            st0 = _State(
                x=x0, r=r, z=z, p=z, rho=rho,
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
                # live: this solve is still iterating.  Under vmap the
                # while_loop runs until the SLOWEST batch element's cond
                # clears, and the body executes for ALL elements — COCG's
                # non-minimizing recurrence WANDERS after convergence (the
                # indefinite bilinear form gives no monotonicity), so a
                # converged column left un-frozen is DESTROYED by the
                # overrun (found as garbage inner solves in the rational
                # filter's batched path).  Freeze everything once the
                # element's own exit condition holds.
                live = (s_.status == Status.RUNNING) & (s_.r_norm > tol2)
                # ρ-breakdown: the bilinear form is indefinite — rᵀz can
                # vanish without convergence. Predicated terminal exit
                # (the lax.cond-free discipline of bicgstab's hot body).
                ok_rho = _mag(s_.rho) > brk_tol

                q = A.matvec(s_.p)
                pq = dot(s_.p, q, axis_name)
                ok_pq = _mag(pq) > brk_tol
                ok = ok_rho & ok_pq
                upd = live & ok

                alpha = s_.rho / jnp.where(ok, pq, jnp.ones((), T))
                x = axpy(alpha, s_.p, s_.x)
                r_new = axpy(-alpha, q, s_.r)
                z_new = M.matvec(r_new)
                # tail-fused reductions: one pass over (r_new, z_new)
                rho_new = dot(r_new, z_new, axis_name)
                r_norm = norm2(r_new, axis_name)
                beta = rho_new / jnp.where(ok, s_.rho, jnp.ones((), T))
                p = axpy(beta, s_.p, z_new)

                return _State(
                    x=jnp.where(upd, x, s_.x),
                    r=jnp.where(upd, r_new, s_.r),
                    z=jnp.where(upd, z_new, s_.z),
                    p=jnp.where(upd, p, s_.p),
                    rho=jnp.where(upd, rho_new, s_.rho),
                    r_norm=jnp.where(upd, r_norm, s_.r_norm),
                    its=jnp.where(upd, s_.its + 1, s_.its),
                    status=jnp.where(
                        live & ~ok, jnp.int32(Status.BREAKDOWN), s_.status
                    ),
                    res=jnp.where(
                        live & ~ok, s_.r_norm / rhs_norm, s_.res
                    ),
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
