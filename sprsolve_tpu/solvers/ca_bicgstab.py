"""s-step (communication-avoiding) BiCGStab.

The latency end of the *nonsymmetric* family, completing the s-step story
started by :func:`~sprsolve_tpu.solvers.ca_cg.ca_cg` (the reference's
nonsymmetric solver is plain BiCGStab, ``src/bicg_stab.rs``; its hot loop
spends 4 dependent inner products + 1 norm per iteration, each a separate
all-reduce round on a mesh — ``src/bicg_stab.rs:122-197``).

Formulation (Carson, Demmel & Knight's CA-BiCGStab): per outer block,
build the 4s+1 basis vectors V = [ρ₀(A)p … ρ_{2s}(A)p, ρ₀(A)r … ρ_{2s−1}(A)r]
— each BiCGStab step consumes TWO polynomial degrees (v = A·p and t = A·s),
so s steps need degree 2s — then form the (4s+1)² Gram matrix G = VᴴV and
the shadow projection g = Vᴴ·r̃₀ with ONE fused ``psum``, and run s exact
BiCGStab steps as scalar coefficient recurrences against the replicated
(G, g):

    ρ_j   = gᴴ·b_j                    (= ⟨r̃₀, r_j⟩)
    w_v   = B·a_j                     (coordinates of v = A·p_j)
    α     = ρ_j / gᴴ·w_v              (⟨r̃₀, v⟩ = 0 → BREAKDOWN,
                                       src/bicg_stab.rs:164-167)
    b_s   = b_j − α·w_v               (coordinates of the algorithm's s-vec)
    w_t   = B·b_s                     (coordinates of t = A·s)
    ω     = w_tᴴ·G·b_s / w_tᴴ·G·w_t   (tᴴt ≤ 0 → ω-guard,
                                       src/bicg_stab.rs:179-185)
    c    += α·a_j + ω·b_s             (x-update coordinates)
    b_{j+1} = b_s − ω·w_t
    β     = (ρ_{j+1}/ρ_j)(α/ω) ;  a_{j+1} = b_{j+1} + β(a_j − ω·w_v)

and reconstruct x/r/p with three local (m × 4s+1) GEMVs — tall-skinny
matmuls.  On a banded matrix-powers operator
(:class:`~sprsolve_tpu.parallel.dist_operator.MPKDIA` with depth ≥ 2s) the
whole basis needs ONE depth-2s·h halo exchange, so a block of s BiCGStab
iterations costs {1 all-reduce, 2 ppermutes} vs plain BiCGStab's
{≥3 all-reduce rounds, 4 ppermutes} *per single iteration* — certified
from compiled HLO in ``tests/test_ca_bicgstab.py``.

Numerical-robustness semantics mirror the reference through the package's
outer-anchor pattern (``idrs.py``, ``ca_cg.py``):

- the ρ-breakdown *restart* (``src/bicg_stab.rs:131-145``): when
  |ρ| < (ε·‖r̃₀‖)² the block exits and the outer loop re-anchors — recompute
  the TRUE residual b − A·x, reset r̃₀ := r and p := r.  (The reference
  keeps its p across a restart; the CA block cannot, since p's coordinates
  are only meaningful against the old anchor — a steepest-descent restart
  is the standard CA-KSM choice and is exercised by the tests.)
- ⟨r̃₀, v⟩ = 0 → terminal ``BREAKDOWN`` with x at the previous step, as in
  the reference.
- the ω-guard: tᴴt ≤ 0 with the block residual still above tol exits the
  block to the outer anchor (in the coordinate Gram this is usually f32
  rounding — tt is a quadratic form of an already-squared basis — and the
  exact-residual restart recovers); a true degeneracy recurs against the
  fresh anchor and burns the budget → ``INSUFFICIENT_ITER``, never a
  false ``BREAKDOWN``.  (The plain solver's ω = 0 path poisons β and
  surfaces the same failure one iteration later.)
- the inner loop exits on the cheap *coordinate* norm b_jᴴ·G·b_j; every
  outer pass re-anchors on the exact residual, and CONVERGED is gated on
  the TRUE residual only — the solver never reports success (or failure)
  off the recurrence value.

Basis conditioning: one block spans polynomial degree 2s — twice CA-CG's —
so conditioning bites at half the s.  Default is s = 2 and the Chebyshev
basis when ``bounds`` are given (Gershgorin is free:
:func:`sprsolve_tpu.gershgorin_bounds`); for strongly nonsymmetric spectra
the real-interval Chebyshev basis still conditions on the field-of-values
projection onto the real axis, which the convection-diffusion tests cover.

Single-device cost: the basis build applies A to a 2-column block 2s times
per s iterations — ~2× plain BiCGStab's SpMV work — and on one device that
is pure cost.  Reach for this solver only across a mesh where
reduction-round latency dominates; on a single device prefer
:func:`~sprsolve_tpu.solvers.bicgstabl.bicgstabl`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..vecalg import axpy, conj_dot, eps_for, norm2
from .ca_cg import _basis_change
from .common import check_shapes, make_info

_HI = lax.Precision.HIGHEST


class _State(NamedTuple):
    x: jax.Array
    r: jax.Array        # recurrence residual (exact at outer anchors)
    p: jax.Array
    rt0: jax.Array      # shadow residual r̃₀, fixed within a block sequence
    rn2: jax.Array      # real ‖r‖² (exact at outer anchors)
    rn2_anchor: jax.Array  # real ‖r‖² at the last outer anchor (exact)
    rt0_tol: jax.Array  # real (ε·‖r̃₀‖)² — the ρ-restart threshold
    need_anchor: jax.Array  # bool: ρ collapsed, outer loop must re-anchor
    its: jax.Array
    status: jax.Array
    hist: jax.Array


# Block-divergence cap: a block whose coordinate ‖r‖² exceeds this factor
# times the last anchor's exact ‖r‖² is rolled back wholesale (its Gram is
# poisoned — typically Chebyshev ``bounds`` that miss the spectrum, under
# which the basis grows like cosh(2s·dist)).  ‖r‖ excursions of 1e3-1e4
# above the anchor are NORMAL BiCGStab oscillation, i.e. 1e8 on ‖r‖² —
# 1e12 sits safely above that and far below genuine basis explosion.
_DIVERGENCE_CAP = 1e12


def ca_bicgstab(
    A,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    s: int = 2,
    basis: str = "auto",
    bounds=None,
    tol,
    max_iter,
    axis_name: Optional[str] = None,
    record_residuals: bool = False,
):
    """Solve general A·x = b with s-step BiCGStab. Returns ``(x, SolveInfo)``.

    ``s``: BiCGStab iterations per communication block (static; 2–4
    sensible — one block spans polynomial degree 2s, so basis conditioning
    bites at half of CA-CG's usable s).  ``basis``/``bounds`` as in
    :func:`~sprsolve_tpu.solvers.ca_cg.ca_cg`.  ``iterations`` counts
    BiCGStab steps (2 SpMVs each), directly comparable to
    :func:`~sprsolve_tpu.solvers.bicgstab.bicgstab`; outer true-residual
    anchors charge +1 each.

    Unpreconditioned (like ``ca_cg``: the preconditioned s-step basis needs
    M-polynomial machinery — use :func:`bicgstab`/:func:`bicgstabl` with
    ``M`` instead).  CONVERGED is gated on the TRUE relative residual.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    if b.ndim != 1:
        from ..errors import IncompatibleMatrixFormat

        raise IncompatibleMatrixFormat(
            "ca_bicgstab works on flat vectors (the basis block stacks p "
            "and r); padded kernel layouts are not supported here"
        )
    if s < 1:
        raise ValueError(f"need s >= 1, got {s}")
    if basis == "auto":
        basis = "chebyshev" if bounds is not None else "monomial"
    if basis == "chebyshev":
        if bounds is None:
            raise ValueError("basis='chebyshev' needs bounds=(lo, hi)")
        lo, hi = float(bounds[0]), float(bounds[1])
        theta = 0.5 * (hi + lo)
        delta = max(0.5 * (hi - lo), 1e-30)
    elif basis == "monomial":
        theta, delta = 0.0, 1.0
    else:
        raise ValueError(f"unknown basis {basis!r}")
    deg = 2 * s  # polynomial degree one block consumes
    if hasattr(A, "max_power") and deg > A.max_power:
        raise ValueError(
            f"s={s} needs matrix-powers depth 2s={deg}, exceeding the "
            f"operator's {A.max_power} (ext={A.ext}, halo={A.halo}); "
            f"partition with mpk_s=2*s"
        )

    T = b.dtype
    rdt = jnp.finfo(T).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    hist_len = int(max_iter) + 1 if record_residuals else 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(T)
    epsr = jnp.asarray(eps, rdt)
    tiny = jnp.asarray(jnp.finfo(rdt).tiny, rdt)
    t = 2 * deg + 1  # 4s+1 basis columns
    Bmat = jnp.asarray(_basis_change(deg, basis, theta, delta), rdt)
    mpk = hasattr(A, "mpk_extend") and axis_name is not None
    one = jnp.ones((), T)

    def basis_block(p, r):
        """V = [ρ₀(A)p … ρ_{2s}(A)p, ρ₀(A)r … ρ_{2s−1}(A)r] as (m, 4s+1)."""
        Z = jnp.stack([p, r], axis=1)
        if mpk:
            cur = A.mpk_extend(Z)      # ONE exchange for the whole chain
            apply_, central = A.mpk_apply, A.mpk_central
        else:
            cur = Z
            apply_ = A.matmat if hasattr(A, "matmat") else (
                lambda X: jax.vmap(A.matvec, in_axes=1, out_axes=1)(X)
            )
            central = lambda v: v  # noqa: E731
        chain = [cur]
        for j in range(deg):
            Av = apply_(chain[-1])
            if basis == "monomial":
                nxt = Av
            elif j == 0:
                nxt = (Av - theta * chain[-1]) / delta
            else:
                nxt = (2.0 / delta) * (Av - theta * chain[-1]) - chain[-2]
            chain.append(nxt)
        cols = [central(c)[:, 0] for c in chain]          # p-chain, 2s+1
        cols += [central(c)[:, 1] for c in chain[:deg]]   # r-chain, 2s
        return jnp.stack(cols, axis=1)

    def gram_ext(V, rt0):
        """(G, g) = (VᴴV, Vᴴr̃₀) — ONE matmul, ONE psum."""
        W = jnp.concatenate([V, rt0[:, None]], axis=1)
        GE = jnp.matmul(V.conj().T, W, precision=_HI)
        if axis_name is not None:
            GE = lax.psum(GE, axis_name)
        return GE[:, :t], GE[:, t]

    def main(rhs_norm):
        tol2sq = jnp.square(tol * rhs_norm)

        r0 = axpy(-one, A.matvec(x0), b)
        rn2_0 = jnp.real(conj_dot(r0, r0, axis_name))
        st0 = _State(
            x=x0, r=r0, p=r0, rt0=r0, rn2=rn2_0, rn2_anchor=rn2_0,
            rt0_tol=jnp.square(epsr) * rn2_0,
            need_anchor=jnp.asarray(False),
            its=jnp.int32(0), status=jnp.int32(Status.RUNNING),
            hist=jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

        def cond_fn(st):
            return (
                (st.status == Status.RUNNING)
                & ~st.need_anchor
                & (st.its < max_iter)
                & (st.rn2 > tol2sq)
            )

        def body_fn(st):
            V = basis_block(st.p, st.r)
            G, g = gram_ext(V, st.rt0)      # the block's ONE all-reduce
            gh = g.conj()
            a = jnp.zeros(t, T).at[0].set(1.0)
            bv = jnp.zeros(t, T).at[deg + 1].set(1.0)
            c = jnp.zeros(t, T)
            rn2 = st.rn2
            its, status, hist = st.its, st.status, st.hist
            need_anchor = st.need_anchor
            active = jnp.asarray(True)
            for _ in range(s):
                rho = gh @ bv
                # ρ-restart predicate (src/bicg_stab.rs:131-133): the block
                # can't reset r̃₀ itself (its coordinates are against the
                # old anchor) — hand control to the outer anchor loop
                collapse = jnp.abs(rho) < st.rt0_tol
                wv = (Bmat @ a).astype(T)
                delta_ = gh @ wv
                ok_d = jnp.abs(delta_) > 0
                alpha = rho / jnp.where(ok_d, delta_, one)
                bs = bv - alpha * wv
                wt = (Bmat @ bs).astype(T)
                Gbs = G @ bs
                Gwt = G @ wt
                tt = jnp.real(wt.conj() @ Gwt)
                ts = wt.conj() @ Gbs
                sn2 = jnp.maximum(jnp.real(bs.conj() @ Gbs), 0.0)
                ok_t = tt > 0
                omega = jnp.where(ok_t, ts / jnp.where(ok_t, tt, 1.0),
                                  jnp.zeros((), T))
                step = active & ok_d & ~collapse & (its < max_iter)
                # ω-guard (src/bicg_stab.rs:179-185): tᴴt ≤ 0 while the
                # block residual is above tol.  In exact arithmetic that
                # means t = A·s vanished without s doing so, but in the
                # coordinate Gram it is usually rounding (tt is a quadratic
                # form of an already-squared basis — observed spuriously in
                # f32) — treat it like ρ-collapse: exit the block and let
                # the outer anchor rebuild from the exact residual.  A true
                # degeneracy recurs against the fresh anchor and burns the
                # budget → INSUFFICIENT_ITER, never a false BREAKDOWN.
                degen = ~ok_t & (sn2 > tol2sq)
                c = jnp.where(step, c + alpha * a + omega * bs, c)
                bnew = jnp.where(step, bs - omega * wt, bv)
                rn2_new = jnp.maximum(jnp.real(bnew.conj() @ (G @ bnew)), 0.0)
                rn2 = jnp.where(step, rn2_new, rn2)
                rho_new = gh @ bnew
                beta = (rho_new / jnp.where(jnp.abs(rho) > 0, rho, one)) * (
                    alpha / jnp.where(jnp.abs(omega) > 0, omega, one)
                )
                a = jnp.where(step & ok_t, bnew + beta * (a - omega * wv), a)
                if hist_len:
                    idx = jnp.minimum(its, max_iter)
                    hist = hist.at[idx].set(jnp.where(
                        step, jnp.sqrt(rn2) / rhs_norm, hist[idx]
                    ))
                bv = bnew
                status = jnp.where(
                    active & ~collapse & ~ok_d,
                    jnp.int32(Status.BREAKDOWN), status,
                )
                need_anchor = need_anchor | (active & (collapse | degen))
                its = jnp.where(step, its + 1, its)
                active = step & ~degen & (rn2 > tol2sq)
            # Block-divergence rollback: a coordinate ‖r‖² this far above
            # the anchor means the basis itself exploded (bounds missing
            # the spectrum) — the whole block's Gram is garbage, so DISCARD
            # the block's iterates and hand to the outer anchor.  ``its``
            # keeps the attempted steps so a persistently diverging basis
            # exhausts the budget (honest INSUFFICIENT_ITER at the last
            # good anchor) instead of looping forever or returning a
            # poisoned x.
            # ~(≤) rather than (>) so NaN (inf−inf in a blown-up block)
            # also counts as diverged
            diverged = ~(
                rn2 <= jnp.asarray(_DIVERGENCE_CAP, rdt) * st.rn2_anchor
            )
            need_anchor = need_anchor | diverged
            # reconstruct the iterates — three local tall-skinny GEMVs
            x = st.x + jnp.matmul(V, c, precision=_HI)
            r = jnp.matmul(V, bv, precision=_HI)
            p = jnp.matmul(V, a, precision=_HI)
            return _State(
                x=jnp.where(diverged, st.x, x),
                r=jnp.where(diverged, st.r, r),
                p=jnp.where(diverged, st.p, p),
                rt0=st.rt0,
                rn2=jnp.where(diverged, st.rn2, rn2),
                rn2_anchor=st.rn2_anchor,
                rt0_tol=st.rt0_tol, need_anchor=need_anchor,
                its=its, status=status, hist=hist,
            )

        # Outer anchor loop (the idrs.py / ca_cg.py pattern): re-anchor on
        # the TRUE residual b − A·x, reset the shadow residual r̃₀ := r and
        # restart direction p := r — this is simultaneously the s-step
        # drift correction AND the reference's ρ-breakdown restart
        # (src/bicg_stab.rs:131-145: recompute r, reset r̃₀, re-derive the
        # restart threshold).
        def outer_cond(o):
            return (
                (o.status == Status.RUNNING)
                & (o.its < max_iter)
                & ((o.rn2 > tol2sq) | o.need_anchor)
            )

        def outer_body(o):
            inner = lax.while_loop(cond_fn, body_fn, o)
            r_true = axpy(-one, A.matvec(inner.x), b)
            rn2 = jnp.real(conj_dot(r_true, r_true, axis_name))
            return _State(
                x=inner.x, r=r_true, p=r_true, rt0=r_true, rn2=rn2,
                rn2_anchor=rn2,
                rt0_tol=jnp.square(epsr) * jnp.maximum(rn2, tiny),
                need_anchor=jnp.asarray(False),
                its=inner.its + 1, status=inner.status, hist=inner.hist,
            )

        final = lax.while_loop(outer_cond, outer_body, st0)
        # final.rn2 is always TRUE: the initial state's is ‖b − A·x0‖² and
        # every outer_body recomputes it.
        true_res = jnp.sqrt(final.rn2) / rhs_norm
        converged = (final.status == Status.RUNNING) & (true_res <= tol)
        status = jnp.where(
            converged,
            jnp.int32(Status.CONVERGED),
            jnp.where(
                final.status == Status.RUNNING,
                jnp.int32(Status.INSUFFICIENT_ITER),
                final.status,
            ),
        )
        hist = final.hist
        if hist_len:
            idx = jnp.minimum(final.its, max_iter)
            hist = hist.at[idx].set(jnp.where(
                converged, true_res, hist[idx]
            ))
        return final.x, make_info(final.its, true_res, status), hist

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
