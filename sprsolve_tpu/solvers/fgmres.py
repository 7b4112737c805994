"""Flexible GMRES(m) — GMRES with a preconditioner that may change per step.

Not present in the reference (its general-matrix solver is BiCGStab,
``src/bicg_stab.rs``); added for framework completeness. Right-preconditioned
GMRES (``gmres.py``) assumes the preconditioner is a FIXED linear operator:
it reconstructs the update as ``x += M⁻¹(Vₘ·y)``, which is only valid when
every Arnoldi step saw the same M. FGMRES (Saad 1993) drops that assumption
by keeping the *preconditioned* basis ``Z = [M₁⁻¹v₁ … Mₘ⁻¹vₘ]`` alongside V
and updating ``x += Zₘ·y`` — so M may be a different operator each step, and
in particular may be an *inner iterative solver* (a few CG/Chebyshev/MG
cycles), whose action is a nonlinear function of its input. That inner-outer
pattern is the standard way to use a strong-but-inexact preconditioner, and
is exposed here through :class:`sprsolve_tpu.precond.InnerSolvePrecond`.

Design (same skeleton as ``gmres.py``, which documents the CGS2 /
Givens / restart choices):

- One extra ``(m, size)`` carry block Z — the only state delta vs GMRES.
  Per step, right-preconditioned GMRES already pays the one M apply;
  FGMRES *keeps* the result instead of re-applying M once at cycle end;
  its extra cost is the Z-block store traffic, not extra M applies.
- The x-update is ``y·Z`` — one (m,)×(m, size) matmul, mirroring
  the ``y·V`` reconstruction.
- Everything runs inside ``lax.while_loop``s; an inner-solver M compiles to
  a nested ``while_loop`` in the same XLA program (no host round-trips).

Convergence is monitored on the recurrence residual of the ORIGINAL system
(right preconditioning leaves the true residual observable); every restart
starts from the true residual, and CONVERGED is only declared after a
true-residual confirmation at cycle end (recurrence drift under a strongly
variable inner-solve M triggers another restart instead of a false
positive), exactly as in ``gmres.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..vecalg import abs2, conj_dot, eps_for, norm2
from .common import check_shapes, make_info


class _Outer(NamedTuple):
    x: jax.Array
    r: jax.Array         # true residual vector b − A·x (flattened)
    its: jax.Array
    status: jax.Array
    res: jax.Array       # relative TRUE residual of x
    hist: jax.Array


class _Inner(NamedTuple):
    V: jax.Array         # (m+1, size) Arnoldi basis of the original system
    Z: jax.Array         # (m, size) preconditioned basis, Z[j] = M_j⁻¹ V[j]
    R: jax.Array         # (m, m) upper-triangular factor (post-rotation)
    g: jax.Array         # (m+1,) rotated least-squares rhs
    cs: jax.Array        # (m,) Givens cosines
    sn: jax.Array        # (m,) Givens sines (real)
    j: jax.Array
    res_est: jax.Array   # |g[j+1]| recurrence residual (absolute)
    status: jax.Array
    hist: jax.Array


def fgmres(
    A,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    M=None,
    tol,
    max_iter,
    restart: int = 32,
    axis_name: Optional[str] = None,
    record_residuals: bool = False,
):
    """Solve A·x = b with flexible restarted GMRES(m). Returns ``(x, info)``.

    ``M`` is applied once per inner step and its output is stored in the Z
    basis; it need not be linear or constant across steps — any object with
    ``.matvec`` works, including :class:`~sprsolve_tpu.precond.InnerSolvePrecond`
    (an inner Krylov sweep). With a fixed linear ``M``, FGMRES produces the
    same iterates as right-preconditioned GMRES (tested); with ``M=None`` it
    is plain GMRES with one extra (zero) carry block.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    m = int(restart)
    if m < 1:
        raise ValueError("restart must be >= 1")

    T = b.dtype
    rdt = jnp.finfo(T).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    hist_len = int(max_iter) if record_residuals else 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(T)
    tiny = jnp.asarray(jnp.finfo(rdt).tiny, rdt)

    vshape = b.shape
    size = b.size
    arange_m1 = jnp.arange(m + 1)

    # basis matmuls at HIGHEST — same reasoning as gmres.py/lobpcg.py
    _hp = jax.lax.Precision.HIGHEST

    def _basis_dots(V, w):
        h = jnp.matmul(jnp.conj(V), w, precision=_hp)
        if axis_name is not None:
            h = lax.psum(h, axis_name)
        return h

    def main(rhs_norm):
        threshold = tol * rhs_norm

        def inner_cond(s: _Inner):
            return (
                (s.status == Status.RUNNING)
                & (s.j < m)
                & (s.res_est > threshold)
            )

        def make_inner_body(its0):
            def inner_body(s: _Inner):
                j = s.j
                v_j = s.V[j].reshape(vshape)
                z = M.matvec(v_j) if M is not None else v_j
                Z = s.Z.at[j].set(z.reshape(size)) if M is not None else s.Z
                w = A.matvec(z).reshape(size)

                mask = (arange_m1 <= j).astype(rdt)
                h1 = mask * _basis_dots(s.V, w)
                w = w - jnp.matmul(h1, s.V, precision=_hp)
                h2 = mask * _basis_dots(s.V, w)
                w = w - jnp.matmul(h2, s.V, precision=_hp)
                h = h1 + h2

                wn2 = conj_dot(w, w, axis_name)
                h_next = jnp.sqrt(jnp.maximum(jnp.real(wn2), 0))
                V = s.V.at[j + 1].set(w / jnp.maximum(h_next, tiny))

                hc = jnp.where(arange_m1 == j + 1, h_next.astype(T), h)

                def rot_body(i, hc):
                    apply = i < j
                    a_, b_ = hc[i], hc[i + 1]
                    na = jnp.conj(s.cs[i]) * a_ + s.sn[i] * b_
                    nb = -s.sn[i] * a_ + s.cs[i] * b_
                    hc = hc.at[i].set(jnp.where(apply, na, a_))
                    return hc.at[i + 1].set(jnp.where(apply, nb, b_))

                hc = lax.fori_loop(0, m, rot_body, hc)

                a_ = hc[j]
                t = jnp.sqrt(abs2(a_) + h_next * h_next)
                brk = t <= tiny
                t_safe = jnp.maximum(t, tiny)
                c = jnp.where(brk, jnp.ones((), T), a_ / t_safe)
                sr = jnp.where(brk, jnp.zeros((), rdt), h_next / t_safe)

                r_jj = jnp.conj(c) * a_ + sr * h_next.astype(T)
                hc = hc.at[j].set(r_jj)
                R = s.R.at[:, j].set(hc[:m])
                cs = s.cs.at[j].set(c)
                sn = s.sn.at[j].set(sr)

                gj = s.g[j]
                g = s.g.at[j].set(jnp.conj(c) * gj)
                g = g.at[j + 1].set((-sr) * gj)
                res_est = jnp.abs(g[j + 1])

                hist = s.hist
                if hist_len:
                    hist = hist.at[its0 + j].set(res_est / rhs_norm)

                return _Inner(
                    V=V, Z=Z, R=R, g=g, cs=cs, sn=sn,
                    j=j + 1,
                    res_est=res_est,
                    status=jnp.where(
                        brk, jnp.int32(Status.BREAKDOWN), s.status
                    ),
                    hist=hist,
                )

            return inner_body

        def outer_cond(s: _Outer):
            return (s.status == Status.RUNNING) & (s.its < max_iter)

        def outer_body(s: _Outer):
            # carried TRUE residual of s.x (computed at previous cycle end)
            r = s.r
            beta = norm2(r, axis_name)

            V0 = jnp.zeros((m + 1, size), T)
            V0 = V0.at[0].set(r / jnp.maximum(beta, tiny))
            steps_left = max_iter - s.its
            inner0 = _Inner(
                V=V0,
                Z=jnp.zeros((m, size), T),
                R=jnp.zeros((m, m), T),
                g=jnp.zeros((m + 1,), T).at[0].set(beta.astype(T)),
                cs=jnp.ones((m,), T),
                sn=jnp.zeros((m,), rdt),
                j=jnp.int32(0),
                res_est=beta,
                status=s.status,
                hist=s.hist,
            )

            def inner_cond_capped(si: _Inner):
                return inner_cond(si) & (si.j < steps_left)

            fin = lax.while_loop(
                inner_cond_capped, make_inner_body(s.its), inner0
            )
            k = fin.j

            idx = jnp.arange(m)
            diag_safe = jnp.where(
                (idx < k) & (jnp.abs(jnp.diagonal(fin.R)) > tiny),
                jnp.diagonal(fin.R),
                jnp.ones((m,), T),
            )
            Rm = fin.R.at[idx, idx].set(diag_safe)
            gm = jnp.where(idx < k, fin.g[:m], jnp.zeros((), T))
            y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)

            # THE flexible step: x += Z·y (per-step preconditioned vectors),
            # never M⁻¹(V·y) — no assumption that M was constant this cycle
            basis = fin.Z if M is not None else fin.V[:m]
            dx = jnp.matmul(y, basis, precision=_hp).reshape(vshape)
            x = s.x + dx

            # true-residual anchor at cycle end (same matvec budget — the
            # cycle-top recompute moved here).  Matters more for FGMRES
            # than for GMRES: a strongly variable inner-solve M lets the
            # CGS2 recurrence estimate drift from the true residual, so
            # CONVERGED is confirmed on the true residual (else the outer
            # loop restarts from it), and every exit — BREAKDOWN included,
            # whose branch forces g[j+1]=0 — reports the actual residual
            r_new = (b - A.matvec(x).reshape(vshape)).reshape(size)
            res_true = norm2(r_new, axis_name) / rhs_norm

            converged = (fin.res_est <= threshold) & (res_true <= tol)
            status = jnp.where(
                converged & (fin.status == Status.RUNNING),
                jnp.int32(Status.CONVERGED),
                fin.status,
            )
            return _Outer(
                x=x,
                r=r_new,
                its=s.its + k,
                status=status,
                res=res_true,
                hist=fin.hist,
            )

        r0 = (b - A.matvec(x0).reshape(vshape)).reshape(size)
        st0 = _Outer(
            x=x0,
            r=r0,
            its=jnp.int32(0),
            status=jnp.int32(Status.RUNNING),
            res=norm2(r0, axis_name) / rhs_norm,
            hist=jnp.full(hist_len, jnp.nan, dtype=rdt),
        )
        final = lax.while_loop(outer_cond, outer_body, st0)
        status = jnp.where(
            final.status == Status.RUNNING,
            jnp.int32(Status.INSUFFICIENT_ITER),
            final.status,
        )
        return final.x, make_info(final.its, final.res, status), final.hist

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
