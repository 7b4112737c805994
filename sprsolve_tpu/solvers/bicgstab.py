"""BiCGStab for general (non-symmetric, possibly indefinite) systems.

Re-design of the reference solver (``src/bicg_stab.rs``): the
preallocated 7n workspace becomes the ``lax.while_loop`` carry pytree (with
buffer donation there is no per-iteration allocation), early returns become a
status code in the carry, and the rare branches are replicated exactly so
iteration counts match the reference: the ω-guard (``:179-185``) and
breakdown exit (``:164-167``) as predicated selects, and the ρ-breakdown
restart (``:131-145``) as a nested-loop exit — the inner ``while_loop`` runs
the restart-free iteration, an outer loop performs the (rare) restart.  A
``lax.cond`` carrying vectors inside the hot body would force full-vector
copies every iteration (observed as 4 async copies in the compiled HLO).

The unpreconditioned path is the preconditioned path with M = I: in the
reference the two are separate functions, but with an identity M every
intermediate (y = M⁻¹p ≡ p, z = M⁻¹r ≡ r) is bitwise identical to the
unpreconditioned arithmetic (``src/bicg_stab.rs:64-120`` vs ``:234-293``), so
one implementation serves both with no parity loss.

Sign convention: r = A·x − b (``src/bicg_stab.rs:73-75``), hence the x-updates
subtract. Residual reported is relative: ‖r‖/‖b‖ (``:124-126``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import SolveInfo, Status
from ..ops.operator import (
    IdentityOperator,
    mv_prec_wdot,
    mv_prec_wdot2,
)
from ..vecalg import axpby, axpy, conj_dot, eps_for, norm2
from .common import check_shapes, make_info


def _guard3(b, x0, main, axis_name, hist_len, rdt):
    """Zero-rhs guard for the 3-output (x, info, hist) form."""
    from ..vecalg import eps_for, norm2 as _n2

    rhs_norm = _n2(b, axis_name)
    eps = eps_for(b.dtype)

    def trivial(_):
        return (
            jnp.zeros_like(x0),
            make_info(0, rhs_norm, Status.CONVERGED),
            jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

    return lax.cond(rhs_norm <= eps, trivial, lambda _: main(rhs_norm), None)


class _State(NamedTuple):
    x: jax.Array
    r: jax.Array
    r0: jax.Array
    p: jax.Array
    v: jax.Array
    rho: jax.Array          # T scalar: ρ of the iteration just completed
    rho_next: jax.Array     # T scalar: conj(r0)·r of the carried vectors —
                            # computed at the tail, fused with ‖r‖ (one pass)
    alpha: jax.Array        # T scalar
    w: jax.Array            # T scalar
    r0_norm_tol: jax.Array  # real scalar, already squared (src/bicg_stab.rs:84-85)
    r_norm: jax.Array       # real scalar: ‖r‖ of the carried r (checked in cond)
    its: jax.Array          # int32
    status: jax.Array       # int32
    res: jax.Array          # real scalar: relative residual at termination
    hist: jax.Array         # (max_iter+1,) per-iteration relative residuals, or (0,)


def bicgstab(
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
    """Solve A·x = b with BiCGStab. Returns ``(x, SolveInfo)``.

    ``x0`` doubles as the warm-start initial guess, as in the reference where
    ``x`` is an in/out argument (``src/bicg_stab.rs:72-75``).  ``M`` is the
    preconditioner *apply* operator (an approximation of A⁻¹, e.g.
    :class:`~sprsolve_tpu.precond.DiagPrecond`).  ``axis_name`` makes all
    reductions collective for row-partitioned operators under ``shard_map``.

    ``record_residuals=True`` (requires a static ``max_iter``) additionally
    returns the per-iteration relative-residual trace as a third output —
    the observability the reference lacks (SURVEY.md §5: println-only).
    Entries beyond the final iteration are NaN.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    if M is None:
        M = IdentityOperator(b.shape[0])

    rdt = jnp.finfo(b.dtype).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    if record_residuals:
        # +1: hist[i] is the residual after i iterations, and a solve
        # can converge exactly at the max_iter-th — sized statically
        hist_len = int(max_iter) + 1
    else:
        hist_len = 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(b.dtype)
    T = b.dtype

    def main(rhs_norm):
        tol2 = tol * rhs_norm

        # r = A·x − b ; r0 = r (src/bicg_stab.rs:72-79)
        r = axpy(-jnp.ones((), T), b, A.matvec(x0))
        r0_norm = norm2(r, axis_name)

        def early_converged(_):
            hist = jnp.full(hist_len, jnp.nan, dtype=rdt)
            if hist_len:
                hist = hist.at[0].set(r0_norm / rhs_norm)
            return x0, make_info(0, r0_norm / rhs_norm, Status.CONVERGED), hist

        def iterate(_):
            r0 = r
            r0_norm_tol = (r0_norm * eps) ** 2

            # ---- unrolled first iteration (src/bicg_stab.rs:87-120 / :258-293)
            rho = (r0_norm * r0_norm).astype(T)
            p = r
            # y = M⁻¹p and v = A·y with conj(r0)·v taken inside the SpMV
            # pass (the dots BiCGStab needs are against r0/s, not the SpMV
            # input, so the dotmv form doesn't apply); a diagonal M folds
            # into the kernel's input stage so y never round-trips HBM
            y, v, r0v = mv_prec_wdot(A, M, p, r0, axis_name)
            alpha = rho / r0v
            s = axpy(-alpha, v, r)          # r ← r − α·v (now the algorithm's s)
            z, t, st_, tt = mv_prec_wdot2(A, M, s, s, axis_name)
            # conj_dot(t, s) = conj(conj_dot(s, t)) — identical arithmetic,
            # but st_ rides inside the SpMV pass (src/bicg_stab.rs:108-113)
            w = jnp.where(
                jnp.real(tt) > 0,
                jnp.conj(st_) / tt,
                jnp.zeros((), T),
            )
            x = axpy(-alpha, y, x0)
            x = axpy(-w, z, x)
            r_new = axpy(-w, t, s)

            hist0 = jnp.full(hist_len, jnp.nan, dtype=rdt)
            if hist_len:
                hist0 = hist0.at[0].set(r0_norm / rhs_norm)
            st = _State(
                x=x, r=r_new, r0=r0, p=p, v=v,
                rho=rho,
                # next ρ at the tail: XLA fuses it with the ‖r‖ reduction into
                # one pass over (r_new, r0) instead of a fresh top-of-body pass
                rho_next=conj_dot(r0, r_new, axis_name),
                alpha=alpha, w=w, r0_norm_tol=r0_norm_tol,
                r_norm=norm2(r_new, axis_name),
                its=jnp.int32(1), status=jnp.int32(Status.RUNNING),
                res=jnp.zeros((), rdt), hist=hist0,
            )

            # The convergence test lives in the loop conditions (the
            # reference checks at the top of each iteration,
            # src/bicg_stab.rs:123-126 — checking the carried ‖r‖ before
            # running the body is the same sequence).  Keeping it out of the
            # body avoids a vector-carrying lax.cond per iteration.
            #
            # The ρ-breakdown restart predicate exits an INNER while_loop
            # and an outer loop performs the rare restart.  A vector-carrying
            # lax.cond in the body would force four full-vector copies per
            # iteration (MemcpyD2D in the trace): on an H100 (400 W limit)
            # at 10M rows the nested form measured 607 vs 735 µs/iter with
            # f32 DIA bands (PERF.md).

            def cond_outer(s_):
                return (
                    (s_.status == Status.RUNNING)
                    & (s_.its < max_iter)
                    & (s_.r_norm > tol2)
                )

            def restart_needed(s_):
                # ρ-breakdown predicate (src/bicg_stab.rs:131-133); ρ of the
                # carried vectors was computed at the previous tail
                return jnp.abs(s_.rho_next) < s_.r0_norm_tol

            def restart_values(x):
                # the ρ-breakdown restart recompute (src/bicg_stab.rs:131-145):
                # r and r0 reset to A·x − b, ρ to ‖r‖², the restart tolerance
                # re-derived
                r_r = axpy(-jnp.ones((), T), b, A.matvec(x))
                rn = norm2(r_r, axis_name)
                rho_r = (rn * rn).astype(T)
                tol_r = jnp.real(rho_r) * eps * eps
                return r_r, rho_r, tol_r

            def cond_inner(s_):
                return cond_outer(s_) & ~restart_needed(s_)

            def body_fn(s_):
                r_norm = s_.r_norm
                if hist_len:
                    s_ = s_._replace(
                        hist=s_.hist.at[s_.its].set(r_norm / rhs_norm)
                    )

                def step(s_):
                    rho_old = s_.rho
                    # ρ = conj(r0)·r was computed at the previous tail, fused
                    # with the ‖r‖ pass (identical value, one fewer pass here)
                    rho = s_.rho_next
                    # restart handled by the outer loop
                    r_, r0_, r0_norm_tol = s_.r, s_.r0, s_.r0_norm_tol

                    beta = (rho / rho_old) * (s_.alpha / s_.w)
                    # p = r + β·(p − ω·v), MKL-axpby form (src/bicg_stab.rs:153-156)
                    p = axpby(-beta * s_.w, s_.v, beta, s_.p)
                    p = axpy(jnp.ones((), T), r_, p)

                    y, v, r0v = mv_prec_wdot(A, M, p, r0_, axis_name)

                    # breakdown exit |r0·v| ≤ 0 (src/bicg_stab.rs:164-167) as
                    # predicated arithmetic, not a lax.cond: a vector-carrying
                    # cond in the body costs ~40% of the loop (see cond_fn
                    # note); breakdown is terminal and rare, so compute the
                    # full advance with a guarded divisor and keep the
                    # previous x/count via scalar-predicate selects (XLA fuses
                    # them into the producing passes). Bitwise identical to
                    # the branch form whenever no breakdown occurs.
                    ok = jnp.abs(r0v) > 0
                    alpha = rho / jnp.where(ok, r0v, jnp.ones((), T))
                    sres = axpy(-alpha, v, r_)   # s
                    z, t, st_, tt = mv_prec_wdot2(A, M, sres, sres, axis_name)
                    w = jnp.where(
                        jnp.real(tt) > 0,
                        jnp.conj(st_) / tt,
                        jnp.zeros((), T),
                    )
                    x = axpy(-alpha, y, s_.x)
                    x = axpy(-w, z, x)
                    r_new = axpy(-w, t, sres)
                    return _State(
                        # on breakdown the reference leaves x at the previous
                        # iterate (the error return precedes the x-update)
                        x=jnp.where(ok, x, s_.x),
                        r=r_new, r0=r0_, p=p, v=v,
                        rho=rho, alpha=alpha, w=w,
                        rho_next=conj_dot(r0_, r_new, axis_name),
                        r0_norm_tol=r0_norm_tol,
                        r_norm=jnp.where(
                            ok, norm2(r_new, axis_name), s_.r_norm
                        ),
                        its=jnp.where(ok, s_.its + 1, s_.its),
                        status=jnp.where(
                            ok, s_.status, jnp.int32(Status.BREAKDOWN)
                        ),
                        res=jnp.where(ok, s_.res, r_norm / rhs_norm),
                        hist=s_.hist,
                    )

                return step(s_)

            def outer_body(s_):
                # ρ-breakdown restart (src/bicg_stab.rs:131-145): recompute
                # r from scratch, reset the shadow residual r0.  The carried
                # r_norm is deliberately NOT refreshed — the reference keeps
                # the pre-restart norm until the next tail, and the restarted
                # ρ satisfies |ρ| = ‖r‖² ≥ ‖r‖²ε², so the inner loop always
                # re-enters (no restart livelock).
                def restart(s_):
                    r_r, rho_r, tol_r = restart_values(s_.x)
                    return s_._replace(
                        r=r_r, r0=r_r, rho_next=rho_r, r0_norm_tol=tol_r
                    )

                s_ = lax.cond(restart_needed(s_), restart, lambda s: s, s_)
                return lax.while_loop(cond_inner, body_fn, s_)

            final = lax.while_loop(cond_outer, outer_body, st)

            # classify the exit: converged (‖r‖ ≤ tol2, iters = its at the
            # failed check — identical to the reference's top-of-loop return,
            # src/bicg_stab.rs:124-126), exhausted → InsufficientIterNum
            # (src/bicg_stab.rs:199), or a status set inside the body.
            # its < max_iter required: the reference's loop range ends before
            # a check at its == max_iter could run (src/bicg_stab.rs:122,199)
            converged_exit = (
                (final.status == Status.RUNNING)
                & (final.r_norm <= tol2)
                & (final.its < max_iter)
            )
            status = jnp.where(
                converged_exit,
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
                    converged_exit,
                    hist.at[final.its].set(final.r_norm / rhs_norm),
                    hist,
                )
            return final.x, make_info(final.its, res, status), hist

        return lax.cond(r0_norm <= tol2, early_converged, iterate, None)

    x, info, hist = _guard3(b, x0, main, axis_name, hist_len, rdt)
    if record_residuals:
        return x, info, hist
    return x, info
