"""Preconditioned Conjugate Gradients for SPD / Hermitian-PD systems.

Not present in the reference (its SPD solver is MINRES, ``src/minres.rs``);
added for framework completeness — CG is the flagship SPD Krylov method of
every sparse library (cf. ``scipy.sparse.linalg.cg``) and is strictly
cheaper per iteration than MINRES (one SpMV, two reductions, no Givens
machinery).  Follows this package's solver conventions: ``lax.while_loop``
carry as the workspace, status codes in the carry, reductions ride the
operator's fused forms, ``axis_name`` makes it distributed-collective.

The α-dot is conj(p)·(A·p) — exactly the operator's fused ``matvec_dot``
(the reference's ``mul_vec_dot`` / MKL dotmv shape, ``src/mat.rs:19-22``),
so the per-iteration structure is one fused SpMV pass plus one (r·z, ‖r‖)
tail pass, the same single-reduction-barrier shape as MINRES.

Breakdown semantics: pᴴAp ≤ 0 (operator not positive definite on the
Krylov space) terminates with ``Status.BREAKDOWN`` and the last iterate,
in the spirit of the reference's BiCGStab r0·v = 0 exit
(``src/bicg_stab.rs:164-167``).
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
    z: jax.Array       # M⁻¹·r of the carried r
    p: jax.Array
    rz: jax.Array      # T scalar: conj(r)·z of the carried vectors
    r_norm: jax.Array  # real scalar: ‖r‖ of the carried r (checked in cond)
    its: jax.Array
    status: jax.Array
    res: jax.Array
    hist: jax.Array


def cg(
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
    """Solve SPD A·x = b with (preconditioned) CG. Returns ``(x, SolveInfo)``.

    ``M`` must be an SPD preconditioner apply (≈ A⁻¹), e.g.
    :class:`~sprsolve_tpu.precond.DiagPrecond` or
    :class:`~sprsolve_tpu.precond.IC0Precond`.  Convergence test is
    ‖r‖ ≤ tol·‖b‖ on the true recurrence residual, checked at the top of
    each iteration like the package's other Krylov solvers.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    if M is None:
        M = IdentityOperator(b.shape[0])

    rdt = jnp.finfo(b.dtype).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    # +1: the final write lands at hist[its] with its == max_iter when
    # convergence hits exactly at the budget
    hist_len = int(max_iter) + 1 if record_residuals else 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(b.dtype)
    T = b.dtype

    def main(rhs_norm):
        tol2 = tol * rhs_norm

        r = axpy(-jnp.ones((), T), A.matvec(x0), b)  # r = b − A·x
        r_norm = norm2(r, axis_name)
        z = M.matvec(r)
        st = _State(
            x=x0, r=r, z=z, p=z,
            rz=conj_dot(r, z, axis_name),
            r_norm=r_norm,
            its=jnp.int32(0), status=jnp.int32(Status.RUNNING),
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
            # fused SpMV + conj(p)·A·p (local partial under shard_map —
            # the collective sum is the solver's job, as in minres)
            q, pq = A.matvec_dot(s_.p)
            if axis_name is not None:
                pq = lax.psum(pq, axis_name)
            # positive-definiteness gate as predicated arithmetic (cheap,
            # terminal, rare — same scheme as BiCGStab's breakdown exit)
            ok = jnp.real(pq) > 0
            alpha = s_.rz / jnp.where(ok, pq, jnp.ones((), T))
            x = axpy(alpha, s_.p, s_.x)
            r = axpy(-alpha, q, s_.r)
            z = M.matvec(r)
            rz_new = conj_dot(r, z, axis_name)
            beta = rz_new / s_.rz
            p = axpy(beta, s_.p, z)  # p = z + β·p
            return _State(
                x=jnp.where(ok, x, s_.x),
                r=r, z=z, p=p, rz=rz_new,
                r_norm=jnp.where(ok, norm2(r, axis_name), s_.r_norm),
                its=jnp.where(ok, s_.its + 1, s_.its),
                status=jnp.where(ok, s_.status, jnp.int32(Status.BREAKDOWN)),
                res=jnp.where(ok, s_.res, s_.r_norm / rhs_norm),
                hist=s_.hist,
            )

        final = lax.while_loop(cond_fn, body_fn, st)

        converged_exit = (
            (final.status == Status.RUNNING) & (final.r_norm <= tol2)
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
            final.status == Status.RUNNING, final.r_norm / rhs_norm, final.res
        )
        hist = final.hist
        if hist_len:
            hist = jnp.where(
                converged_exit,
                hist.at[final.its].set(final.r_norm / rhs_norm),
                hist,
            )
        return final.x, make_info(final.its, res, status), hist

    rhs_norm = norm2(b, axis_name)

    def trivial(_):
        return (
            jnp.zeros_like(x0),
            make_info(0, rhs_norm, Status.CONVERGED),
            jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

    x, info, hist = lax.cond(
        rhs_norm <= eps, trivial, lambda _: main(rhs_norm), None
    )
    if record_residuals:
        return x, info, hist
    return x, info


class _SS(NamedTuple):
    x: jax.Array
    r: jax.Array
    u: jax.Array        # M⁻¹·r
    w: jax.Array        # A·u
    p: jax.Array
    s: jax.Array        # A·p, maintained by recurrence (never re-applied)
    gamma: jax.Array    # conj(r)·u
    delta: jax.Array    # conj(u)·w
    gamma_prev: jax.Array
    alpha_prev: jax.Array
    r_norm: jax.Array
    its: jax.Array
    status: jax.Array
    res: jax.Array
    hist: jax.Array


def cg_single_sync(
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
    """Chronopoulos–Gear CG: ONE reduction round per iteration.

    Mathematically the same Krylov iteration as :func:`cg`, restructured so
    all three inner products of a step — γ = conj(r)·u, δ = conj(u)·w and
    ‖r‖² — are computed back-to-back and cross the device mesh as a SINGLE
    fused ``psum`` of a stacked (3,) vector.  Plain CG needs two dependent
    reduction rounds (conj(p)·A·p gates the x/r update that feeds r·z), so
    on an N-chip mesh where all-reduce latency dominates the tiny local
    dots, this halves the per-iteration synchronization cost — the
    communication-avoiding trade from Chronopoulos & Gear (1989) / the
    PETSc ``KSPPIPECG`` family.  Certified from compiled HLO:
    ``tests/test_comm_volume.py`` counts exactly one while-body all-reduce
    here vs two for :func:`cg`.

    The price is one extra vector recurrence: s = A·p is carried
    (s ← w + β·s) instead of re-applied, so rounding drift in s is not
    self-correcting — the classical CA trade.  In f32 on well-conditioned
    systems iteration counts match plain CG to within a couple of
    iterations (tests); for very ill-conditioned systems at tight
    tolerances prefer :func:`cg`.

    Single-chip the reduction fusion is near-neutral (XLA already fuses the
    local tail passes); this exists for the distributed regime.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    if M is None:
        M = IdentityOperator(b.shape[0])

    rdt = jnp.finfo(b.dtype).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    hist_len = int(max_iter) + 1 if record_residuals else 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(b.dtype)
    T = b.dtype

    def fused_dots(r, u, w):
        """(conj(r)·u, conj(u)·w, ‖r‖²) in ONE collective round."""
        g = conj_dot(r, u)
        d = conj_dot(u, w)
        rr = conj_dot(r, r)
        stacked = jnp.stack([g, d, rr])
        if axis_name is not None:
            stacked = lax.psum(stacked, axis_name)
        return stacked[0], stacked[1], jnp.sqrt(jnp.abs(stacked[2]))

    def main(rhs_norm):
        tol2 = tol * rhs_norm

        r = axpy(-jnp.ones((), T), A.matvec(x0), b)
        u = M.matvec(r)
        w = A.matvec(u)
        gamma, delta, r_norm = fused_dots(r, u, w)
        st = _SS(
            x=x0, r=r, u=u, w=w,
            p=jnp.zeros_like(b), s=jnp.zeros_like(b),
            gamma=gamma, delta=delta,
            gamma_prev=jnp.ones((), T), alpha_prev=jnp.ones((), T),
            r_norm=r_norm,
            its=jnp.int32(0), status=jnp.int32(Status.RUNNING),
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
            first = s_.its == 0
            beta = jnp.where(
                first, jnp.zeros((), T), s_.gamma / s_.gamma_prev
            )
            # α = γ / (δ − β·γ/α_prev); for the first step β = 0 → γ/δ
            denom = s_.delta - beta * s_.gamma / s_.alpha_prev
            # positive-definiteness gate (δ-recurrence form of cg's pᴴAp>0)
            ok = jnp.real(denom) > 0
            alpha = s_.gamma / jnp.where(ok, denom, jnp.ones((), T))
            p = axpy(beta, s_.p, s_.u)      # p = u + β·p
            sv = axpy(beta, s_.s, s_.w)     # s = w + β·s  (= A·p)
            x = axpy(alpha, p, s_.x)
            r = axpy(-alpha, sv, s_.r)
            u = M.matvec(r)
            w = A.matvec(u)
            gamma, delta, r_norm = fused_dots(r, u, w)
            return _SS(
                x=jnp.where(ok, x, s_.x),
                r=r, u=u, w=w, p=p, s=sv,
                gamma=gamma, delta=delta,
                gamma_prev=s_.gamma, alpha_prev=alpha,
                r_norm=jnp.where(ok, r_norm, s_.r_norm),
                its=jnp.where(ok, s_.its + 1, s_.its),
                status=jnp.where(ok, s_.status, jnp.int32(Status.BREAKDOWN)),
                res=jnp.where(ok, s_.res, s_.r_norm / rhs_norm),
                hist=s_.hist,
            )

        final = lax.while_loop(cond_fn, body_fn, st)

        converged_exit = (
            (final.status == Status.RUNNING) & (final.r_norm <= tol2)
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
            final.status == Status.RUNNING, final.r_norm / rhs_norm, final.res
        )
        hist = final.hist
        if hist_len:
            hist = jnp.where(
                converged_exit,
                hist.at[final.its].set(final.r_norm / rhs_norm),
                hist,
            )
        return final.x, make_info(final.its, res, status), hist

    rhs_norm = norm2(b, axis_name)

    def trivial(_):
        return (
            jnp.zeros_like(x0),
            make_info(0, rhs_norm, Status.CONVERGED),
            jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

    x, info, hist = lax.cond(
        rhs_norm <= eps, trivial, lambda _: main(rhs_norm), None
    )
    if record_residuals:
        return x, info, hist
    return x, info
