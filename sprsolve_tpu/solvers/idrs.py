"""IDR(s): induced dimension reduction for nonsymmetric systems.

Not present in the reference (its nonsymmetric solver is BiCGStab,
``src/bicg_stab.rs``); added for framework completeness — IDR(s) (Sonneveld
& van Gijzen 2008, biorthogonal variant of van Gijzen & Sonneveld 2011) is
the modern short-recurrence alternative: per cycle it spends s+1 SpMVs and
provably shrinks the residual into a space of dimension reduced by s, often
converging in fewer total SpMVs than BiCGStab (= IDR(1) up to rounding) on
hard nonsymmetric problems, without GMRES's growing basis.

Shape: the shadow space P is a *fixed* (n, s) random block, so the
per-step projections Pᴴ·v are (s, n)×(n,) matvecs — tall-skinny matmuls —
and all per-cycle algebra is over static-size (s,)/(s, s) arrays. The k
loop inside a cycle is unrolled (s is a static Python int, default 4);
cycles run under ``lax.while_loop`` with the usual status-code carry.

Preconditioning is right-style as in the reference TOMS algorithm: every
new direction v is replaced by M⁻¹v before multiplication by A.

Cost model: each step streams the (n, s) G/U/P blocks in addition to the
SpMV, so the per-matvec memory traffic is several times BiCGStab's — IDR(s) pays off when *matvec count* is the
bottleneck (hard nonsymmetric spectra, expensive operators), not on easy
stencils where BiCGStab's few vector passes already dominate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..ops.operator import IdentityOperator
from ..vecalg import axpy, conj_dot, norm2
from .common import check_shapes, make_info


def _est_nnz_per_row(A):
    """Best-effort nnz/row of an operator (None when unknowable)."""
    try:
        n = A.shape[0]
        if hasattr(A, "offsets"):          # DIA / distributed DIA
            return len(A.offsets)
        if hasattr(A, "nnz"):              # CSR/COO/CSC
            return A.nnz / max(n, 1)
        if hasattr(A, "k"):                # ELL
            return A.k
        if hasattr(A, "nblk") and hasattr(A, "bs"):   # BSR
            return A.nblk * A.bs * A.bs / max(n, 1)
    except Exception:
        pass
    return None


def _warn_if_shadow_traffic_dominates(A, s: int) -> None:
    """Guidance cutoff: every IDR step streams the (n, s) shadow/direction
    blocks (P, G, U ≈ 3·s vector streams) on top of the SpMV (≈ nnz/row + 2
    streams).  On cheap stencils that makes the per-matvec memory traffic
    several × BiCGStab's — IDR(s) only pays off when *matvec count* is the
    bottleneck.  Warn when the shadow traffic dominates the operator's."""
    import warnings

    npr = _est_nnz_per_row(A)
    if npr is not None and (npr + 2) < 3 * s:
        warnings.warn(
            f"idrs: the (n, {s}) shadow-space streams (~{3*s} vector reads "
            f"per step) dominate this operator's ~{npr + 2:.0f}-stream SpMV;"
            " per-matvec wall cost will be several times BiCGStab's. Prefer"
            " bicgstab/gmres unless matvec COUNT is the bottleneck, or"
            " reduce s.",
            RuntimeWarning,
            stacklevel=3,
        )


class _State(NamedTuple):
    x: jax.Array
    r: jax.Array
    G: jax.Array       # (n, s) directions in the current G_j space
    U: jax.Array       # (n, s) their preimages (A·U ≈ G)
    Mm: jax.Array      # (s, s) Pᴴ·G
    om: jax.Array      # current ω
    r_norm: jax.Array
    its: jax.Array     # matvec count (comparable to other solvers' iters)
    status: jax.Array


def idrs(
    A,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    M=None,
    s: int = 4,
    tol,
    max_iter,
    axis_name: Optional[str] = None,
):
    """Solve nonsymmetric A·x = b with IDR(s). Returns ``(x, SolveInfo)``.

    ``iterations`` counts operator applications (SpMVs) so it is directly
    comparable with BiCGStab's 2-per-iteration cost. ``max_iter`` gates
    cycle entry: a final cycle may finish past it, so up to s+1 extra
    applies can occur. ``M`` is applied as a right preconditioner to each new
    direction. ``s`` is the shadow-space dimension (static; 4 is the
    standard default, 1 ≈ BiCGStab).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    _warn_if_shadow_traffic_dominates(A, int(s))
    if M is None:
        M = IdentityOperator(b.shape[0])
    T = b.dtype
    rdt = jnp.real(b).dtype if jnp.iscomplexobj(b) else jnp.finfo(T).dtype
    tol = jnp.asarray(tol, rdt)
    max_iter = jnp.asarray(max_iter, jnp.int32)
    tiny = jnp.asarray(jnp.finfo(rdt).tiny * 1e3, rdt)
    # vectors may live in a 2-D kernel layout (padded operators); the
    # shadow-space algebra works on raveled views, solution vectors keep
    # their native shape
    n = b.size
    vshape = b.shape
    s = int(s)

    # fixed shadow space: seeded unit-normal block, orthonormalized — the
    # same P for every run of the same shape (deterministic like the rest
    # of the package). Complex systems get a complex shadow space.
    key = jax.random.key(7)
    P = jax.random.normal(key, (n, s), dtype=rdt).astype(T)
    if jnp.iscomplexobj(b):
        P = P + 1j * jax.random.normal(
            jax.random.fold_in(key, 1), (n, s), dtype=rdt
        ).astype(T)
    P, _ = jnp.linalg.qr(P)
    PH = P.conj().T  # (s, n)
    # HIGHEST: a default-precision f32 matmul may run in TF32 (~3 decimal
    # digits), which would corrupt the shadow-space projections
    _hp = lax.Precision.HIGHEST

    def pdot(v):
        h = jnp.matmul(PH, v.reshape(-1), precision=_hp)
        if axis_name is not None:
            h = lax.psum(h, axis_name)
        return h

    def main(rhs_norm):
        tol2 = tol * rhs_norm

        r0 = b - A.matvec(x0)
        st = _State(
            x=x0,
            r=r0,
            G=jnp.zeros((n, s), T),
            U=jnp.zeros((n, s), T),
            Mm=jnp.eye(s, dtype=T),
            om=jnp.ones((), T),
            r_norm=norm2(r0, axis_name),
            its=jnp.int32(1),
            status=jnp.int32(Status.RUNNING),
        )

        def cond_fn(s_):
            return (
                (s_.status == Status.RUNNING)
                & (s_.its < max_iter)
                & (s_.r_norm > tol2)
            )

        def body_fn(s_):
            x, r, G, U, Mm, om = s_.x, s_.r, s_.G, s_.U, s_.Mm, s_.om
            status = s_.status
            its = s_.its
            f = pdot(r)  # (s,)

            for k in range(s):  # static unroll: s is a Python int
                # solve the lower-triangular system M[k:, k:] c = f[k:]
                # (forward substitution, static shapes via masking)
                c = jnp.zeros((s,), T)
                for i in range(k, s):
                    acc = f[i] - (Mm[i] * c).sum()
                    den = Mm[i, i]
                    den = jnp.where(jnp.abs(den) > tiny, den, jnp.ones((), T))
                    c = c.at[i].set(acc / den)
                # v = r − Σ_{i≥k} c_i G_i ; preimage u built the same way
                v = r - jnp.matmul(G, c, precision=_hp).reshape(vshape)
                v = M.matvec(v)
                u = jnp.matmul(U, c, precision=_hp).reshape(vshape) + om * v
                g = A.matvec(u)
                # biorthogonalize g against the already-updated P columns:
                # one full projection, then updated incrementally
                # (Pᴴ(g − α·G_i) = h − α·Mm[:, i] since Mm[:, i] = Pᴴ G_i)
                h = pdot(g)
                for i in range(k):
                    den = Mm[i, i]
                    den = jnp.where(jnp.abs(den) > tiny, den, jnp.ones((), T))
                    alpha = h[i] / den
                    g = g - alpha * G[:, i].reshape(vshape)
                    u = u - alpha * U[:, i].reshape(vshape)
                    h = h - alpha * Mm[:, i]
                mk = h
                Mm = Mm.at[:, k].set(mk)
                dkk = mk[k]
                ok = jnp.abs(dkk) > tiny
                beta = f[k] / jnp.where(ok, dkk, jnp.ones((), T))
                beta = jnp.where(ok, beta, jnp.zeros((), T))
                r = r - beta * g
                x = x + beta * u
                f = f - beta * mk
                G = G.at[:, k].set(g.reshape(-1))
                U = U.at[:, k].set(u.reshape(-1))
                its = its + 1
                status = jnp.where(
                    ok, status, jnp.int32(Status.BREAKDOWN)
                )

            # ω step: enter the next G space, with the TOMS-913
            # "maintaining convergence" safeguard: when t and r are nearly
            # orthogonal (|ρ| < κ) the minimal-residual ω collapses and the
            # recurrence stagnates; rescale ω by κ/|ρ| (κ = 0.7)
            v = M.matvec(r)
            t = A.matvec(v)
            its = its + 1
            tt = jnp.real(conj_dot(t, t, axis_name))
            tr = conj_dot(t, r, axis_name)
            ok_t = tt > jnp.zeros((), rdt)
            safe_tt = jnp.where(ok_t, tt, jnp.ones((), rdt))
            om = tr / safe_tt.astype(T)
            kappa = jnp.asarray(0.7, rdt)
            rho = jnp.abs(tr) / jnp.sqrt(safe_tt * jnp.maximum(
                jnp.real(conj_dot(r, r, axis_name)), tiny))
            om = jnp.where(
                rho < kappa,
                om * (kappa / jnp.maximum(rho, tiny)).astype(T),
                om,
            )
            om = jnp.where(ok_t, om, jnp.zeros((), T))
            status = jnp.where(ok_t, status, jnp.int32(Status.BREAKDOWN))
            x = x + om * v
            r = r - om * t
            return _State(
                x=x, r=r, G=G, U=U, Mm=Mm, om=om,
                r_norm=norm2(r, axis_name),
                its=its,
                status=status,
            )

        # The inner loop exits on the cheap *recurrence* norm; IDR(s)'s
        # recurrence residual drifts from the true residual (observed ~10x
        # at f32 on moderately conditioned systems — the s-dimensional
        # oblique projections compound rounding faster than the two-sided
        # Krylov recurrences).  So wrap an outer restart loop (the analog of
        # BiCGStab's rho-restart, ``src/bicg_stab.rs:131-145``): at each
        # inner exit, recompute the TRUE residual (one extra SpMV per
        # restart — cheap next to a cycle's s+1) and, if it is still above
        # tol with budget remaining, restart the shadow-space recurrence
        # from the current iterate.  The recurrence then re-anchors on the
        # exact residual, so drift resets each restart and the solver keeps
        # iterating until the true residual meets tol (or max_iter /
        # breakdown) — never reporting failure with budget unspent.
        def outer_cond(o):
            return (
                (o.status == Status.RUNNING)
                & (o.its < max_iter)
                & (o.r_norm > tol2)
            )

        def outer_body(o):
            inner = lax.while_loop(cond_fn, body_fn, o)
            r_true = axpy(
                -jnp.ones((), T), A.matvec(inner.x), b
            )  # b - A x, exact
            return _State(
                x=inner.x,
                r=r_true,
                G=jnp.zeros((n, s), T),
                U=jnp.zeros((n, s), T),
                Mm=jnp.eye(s, dtype=T),
                om=jnp.ones((), T),
                r_norm=norm2(r_true, axis_name),
                its=inner.its + 1,
                status=inner.status,
            )

        final = lax.while_loop(outer_cond, outer_body, st)
        # final.r_norm is always a TRUE residual here: the initial state's
        # r_norm is ||b - A x0|| and every outer_body recomputes it, so the
        # post-loop CONVERGED gate needs no extra SpMV.
        true_res = final.r_norm / rhs_norm
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
        return final.x, make_info(final.its, true_res, status)

    from .common import with_zero_rhs_guard

    return with_zero_rhs_guard(b, x0, main, axis_name)
