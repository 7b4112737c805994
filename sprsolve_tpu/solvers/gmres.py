"""Restarted GMRES(m) for general (nonsymmetric / non-Hermitian) systems.

Not present in the reference (its general-matrix solver is BiCGStab,
``src/bicg_stab.rs``); added for framework completeness — GMRES is the
standard robust companion to BiCGStab in every sparse library
(cf. ``scipy.sparse.linalg.gmres``) and is the method of choice when
BiCGStab's short recurrences break down.

Design choices (not a translation of any host GMRES):

- The Arnoldi basis lives as a dense ``(m+1, size)`` matrix in the loop
  carry, and orthogonalization is **CGS2** (classical Gram-Schmidt applied
  twice): each pass is one masked ``V̄·w`` matvec plus one rank-1-style
  correction ``w − h·V`` — two large matmuls instead of m dot kernels.
  Sequential modified Gram-Schmidt would serialize m dot-kernels per step;
  CGS2 has the same O(ε) loss of orthogonality bound in practice and is the
  standard reorthogonalized choice for vector hardware.
- The Hessenberg QR is maintained incrementally with complex Givens
  rotations (the same machinery as MINRES, ``src/minres.rs:123-148``, but
  with the full column history kept in an ``(m, m)`` R factor); the
  recurrence residual ``|g[j+1]|`` gives a free per-step convergence test.
- Rotation replay over the new column is an O(m) predicated ``fori_loop`` of
  scalar ops — negligible next to the O(m·n) matmuls.
- Restart cycles are an outer ``lax.while_loop``; the inner Arnoldi loop is
  itself a ``lax.while_loop`` so converged/broken-down cycles stop paying
  for SpMVs immediately (no fixed-m padding of real work).
- Preconditioning is **right-sided** (solve A·M⁻¹·u = b, x = M⁻¹·u): the
  monitored residual is the *true* residual of the original system, which
  keeps restart decisions honest, and M enters only as one extra apply per
  inner step plus one per cycle.

Per inner step: one SpMV (+ one M apply), two basis matmuls, one norm.
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
    its: jax.Array       # total inner (Arnoldi) steps taken
    status: jax.Array
    res: jax.Array       # relative TRUE residual of x
    hist: jax.Array


class _Inner(NamedTuple):
    V: jax.Array         # (m+1, size) Arnoldi basis (flattened vectors)
    R: jax.Array         # (m, m) upper-triangular factor (post-rotation)
    g: jax.Array         # (m+1,) rotated rhs of the least-squares problem
    cs: jax.Array        # (m,) Givens cosines (dtype T)
    sn: jax.Array        # (m,) Givens sines (real)
    j: jax.Array         # inner step counter
    res_est: jax.Array   # |g[j+1]| recurrence residual (absolute)
    status: jax.Array
    hist: jax.Array


def gmres(
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
    """Solve A·x = b with restarted GMRES(m). Returns ``(x, SolveInfo)``.

    ``restart`` (= m) is the Krylov dimension per cycle and must be static;
    ``max_iter`` bounds the *total* number of inner steps across cycles.
    ``M`` is applied as a right preconditioner (``M ≈ A⁻¹``); convergence is
    ‖b − A·x‖ ≤ tol·‖b‖ on the recurrence residual, which for right
    preconditioning estimates the true residual.
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

    vshape = b.shape          # operator vector layout (may be 2-D padded)
    size = b.size             # local flat length (per shard under shard_map)
    arange_m1 = jnp.arange(m + 1)

    # a default-precision f32 matmul may run in TF32: at 1M-row scale that
    # costs ~1e-2 relative error in the Arnoldi projections and CGS2 loses
    # orthogonality — all basis matmuls run at HIGHEST (same fix as lobpcg)
    _hp = jax.lax.Precision.HIGHEST

    def _basis_dots(V, w):
        """h[i] = conj(V[i])·w for the whole basis in one matmul."""
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
                w = A.matvec(z).reshape(size)

                # CGS2: two masked project-and-subtract passes, each a pair
                # of (m+1, size) matmuls, no sequential dots
                mask = (arange_m1 <= j).astype(rdt)
                h1 = mask * _basis_dots(s.V, w)
                w = w - jnp.matmul(h1, s.V, precision=_hp)
                h2 = mask * _basis_dots(s.V, w)
                w = w - jnp.matmul(h2, s.V, precision=_hp)
                h = h1 + h2

                wn2 = conj_dot(w, w, axis_name)
                h_next = jnp.sqrt(jnp.maximum(jnp.real(wn2), 0))
                V = s.V.at[j + 1].set(w / jnp.maximum(h_next, tiny))

                # column j of the Hessenberg: h[0..j] from the projections,
                # h[j+1] = ‖w‖; replay the j previous rotations (predicated)
                hc = jnp.where(arange_m1 == j + 1, h_next.astype(T), h)

                def rot_body(i, hc):
                    apply = i < j
                    a_, b_ = hc[i], hc[i + 1]
                    na = jnp.conj(s.cs[i]) * a_ + s.sn[i] * b_
                    nb = -s.sn[i] * a_ + s.cs[i] * b_
                    hc = hc.at[i].set(jnp.where(apply, na, a_))
                    return hc.at[i + 1].set(jnp.where(apply, nb, b_))

                hc = lax.fori_loop(0, m, rot_body, hc)

                # new rotation annihilating the subdiagonal h_next
                a_ = hc[j]
                t = jnp.sqrt(abs2(a_) + h_next * h_next)
                brk = t <= tiny  # zero column: A·M⁻¹ singular on the basis
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
                    V=V, R=R, g=g, cs=cs, sn=sn,
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
            # the carried residual is the TRUE residual of s.x, computed at
            # the end of the previous cycle — honest restarts, and the
            # convergence that ends the outer loop is never an estimate
            r = s.r
            beta = norm2(r, axis_name)

            V0 = jnp.zeros((m + 1, size), T)
            V0 = V0.at[0].set(r / jnp.maximum(beta, tiny))
            steps_left = max_iter - s.its
            inner0 = _Inner(
                V=V0,
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

            # back-substitute R[:k,:k]·y = g[:k]; rows ≥ k are masked to the
            # identity with zero rhs so stale entries can't leak in
            idx = jnp.arange(m)
            diag_safe = jnp.where(
                (idx < k) & (jnp.abs(jnp.diagonal(fin.R)) > tiny),
                jnp.diagonal(fin.R),
                jnp.ones((m,), T),
            )
            Rm = fin.R.at[idx, idx].set(diag_safe)
            gm = jnp.where(idx < k, fin.g[:m], jnp.zeros((), T))
            y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)

            dz = jnp.matmul(y, fin.V[:m], precision=_hp).reshape(vshape)
            dx = M.matvec(dz) if M is not None else dz
            x = s.x + dx

            # true-residual anchor at cycle end (same matvec budget — the
            # cycle-top recompute moved here): CONVERGED is only declared
            # when the TRUE residual passes, so recurrence drift triggers
            # another restart instead of a false positive; and every exit
            # (BREAKDOWN included, whose branch forces g[j+1]=0) reports
            # the actual residual of x, never the estimate
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
