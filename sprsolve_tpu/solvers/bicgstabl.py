"""BiCGStab(ℓ) — Sleijpen–Fokkema generalization of BiCGStab.

Beyond the reference (``src/bicg_stab.rs`` implements only ℓ = 1 as plain
BiCGStab): each cycle performs ℓ BiCG steps followed by an ℓ-dimensional
minimal-residual polynomial step, which (a) converges where plain
BiCGStab's one-dimensional MR step stagnates (complex eigenvalue pairs —
the classic ℓ=2 motivation), and (b) amortizes the loop's reduction
barriers over 2ℓ SpMVs instead of 2 — the s-step/communication-avoiding
direction named in ROADMAP #2, realized here in the variant with a
published convergence story rather than an ad-hoc re-association.

Mapping: ℓ is a *static* Python int, so the intra-cycle j/i loops
unroll at trace time into straight-line XLA; only the cycle loop is a
``lax.while_loop``.  Only (x, r₀, u₀, r̃₀) persist across cycles — the
higher-index Krylov vectors are cycle-local temporaries, so the carry stays
at 4 vectors + scalars regardless of ℓ.  The γ-dots of the BiCG half ride
inside the fused SpMV pass (``mv_prec_wdot``), as does each ρ after the
first of a cycle.

Preconditioning is *right* preconditioning on the correction equation:
with x = x₀ + M·z the system (A∘M)·z = b − A·x₀ is solved for z, so the
carried residual is the TRUE residual b − A·x throughout (no preconditioned
-norm convergence tests, unlike left-preconditioned BiCGStab(ℓ)
implementations) and warm starts need no forward application of M⁻¹.

Complex systems use the Hermitian inner product (``conj_dot``) against r̃₀
and in the modified Gram–Schmidt of the MR part, reducing bitwise to the
real arithmetic on real inputs.

Breakdown handling mirrors plain BiCGStab's ρ-restart
(``src/bicg_stab.rs:131-145``) generalized to the cycle structure: a dead
scalar mid-cycle (ρ = 0, γ = ⟨r̃₀, A·M·u⟩ = 0, σⱼ = 0, or a non-finite ω)
abandons the cycle at the last consistent j-step boundary — after step j the
pair (z, r₀) always satisfies r₀ = r_init − (A∘M)·z, so partial progress is
kept — and *restarts the shadow space*: r̃₀ ← r₀, (ρ₀, α, ω) ← (1, 0, 1),
u₀ ← 0.  This is exactly how the border-supported Dirichlet workloads
survive in plain BiCGStab (the fixed shadow residual lives on the identity
rows and deflates after one step).  Two consecutive restarts without a
completed cycle mean the fresh shadow also died — a genuine breakdown —
and report ``Status.BREAKDOWN`` with the iterate at the last boundary.
All of this is scalar-predicated straight-line code (no vector-carrying
``lax.cond`` in the hot body).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..ops.operator import IdentityOperator, mv_prec_wdot
from ..vecalg import axpy, conj_dot, eps_for, norm2
from .bicgstab import _guard3
from .common import check_shapes, make_info


class _State(NamedTuple):
    z: jax.Array        # accumulated correction (x = x0 + M·z)
    r: jax.Array        # r₀ — TRUE residual b − A·x of the current iterate
    u: jax.Array        # u₀ — BiCG direction vector
    rt: jax.Array       # r̃₀ — shadow residual (reset on restart)
    rho0: jax.Array     # T scalar
    alpha: jax.Array    # T scalar
    omega: jax.Array    # T scalar (γ_ℓ of the previous MR step)
    r_norm: jax.Array   # real scalar: ‖r₀‖ of the carried residual
    rcount: jax.Array   # int32 — consecutive shadow restarts (2 ⇒ BREAKDOWN)
    its: jax.Array      # int32 — cycles run (2ℓ SpMVs each)
    status: jax.Array   # int32
    res: jax.Array      # real scalar: relative residual at termination
    hist: jax.Array     # (max_iter+1,) per-cycle relative residuals, or (0,)


def bicgstabl(
    A,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    l: int = 2,
    M=None,
    tol,
    max_iter,
    axis_name: Optional[str] = None,
    record_residuals: bool = False,
):
    """Solve A·x = b with BiCGStab(ℓ). Returns ``(x, SolveInfo)``.

    ``info.iterations`` counts *cycles*; each cycle is 2ℓ operator
    applications (and 2ℓ preconditioner applications when ``M`` is given),
    so cycle counts compare to plain BiCGStab iteration counts at a factor
    of ℓ.  ``max_iter`` bounds cycles.  ``l`` must be a static Python int
    ≥ 1; ``l=1`` is algorithmically plain BiCGStab (different rounding —
    use :func:`~sprsolve_tpu.solvers.bicgstab` for reference parity).

    ``record_residuals=True`` (static ``max_iter``) returns the per-cycle
    relative-residual trace as a third output, NaN beyond the final cycle.
    """
    l = int(l)
    if l < 1:
        raise ValueError(f"bicgstabl needs l >= 1, got {l}")
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    if M is None:
        M = IdentityOperator(b.shape[0])

    rdt = jnp.finfo(b.dtype).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    # +1: a solve can converge exactly at the max_iter-th cycle and the
    # final write lands at hist[max_iter]
    hist_len = int(max_iter) + 1 if record_residuals else 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    T = b.dtype
    one = jnp.ones((), T)

    def main(rhs_norm):
        tol2 = tol * rhs_norm

        # true residual of the warm start; the loop solves (A∘M)·z = r_init
        r_init = axpy(-one, A.matvec(x0), b)  # b − A·x0
        r0_norm = norm2(r_init, axis_name)

        def early_converged(_):
            hist = jnp.full(hist_len, jnp.nan, dtype=rdt)
            if hist_len:
                hist = hist.at[0].set(r0_norm / rhs_norm)
            return x0, make_info(0, r0_norm / rhs_norm, Status.CONVERGED), hist

        def iterate(_):
            # scalar-death threshold at the problem's rounding floor, the
            # BiCGStab ρ-scale convention ((ε‖r₀‖)², src/bicg_stab.rs:84-85).
            # A strict |·| > 0 test is NOT enough: with a near-exact M
            # (e.g. AMG on a small system) the solve completes inside the
            # first inner step, the next step's γ lands at denormal scale
            # (~1e-30), and dividing by it amplifies rounding noise by
            # ~1e15 — committing garbage to (z, r) while the recurrence
            # residual keeps "converging" (caught by the solver×precond
            # compatibility matrix, tests/test_compat_matrix.py).
            brk_tol = (r0_norm * eps_for(b.dtype)) ** 2
            hist0 = jnp.full(hist_len, jnp.nan, dtype=rdt)
            st0 = _State(
                z=jnp.zeros_like(b),
                r=r_init,
                u=jnp.zeros_like(b),
                rt=r_init,
                rho0=one,
                alpha=jnp.zeros((), T),
                omega=one,
                r_norm=r0_norm,
                rcount=jnp.int32(0),
                its=jnp.int32(0),
                status=jnp.int32(Status.RUNNING),
                res=jnp.zeros((), rdt),
                hist=hist0,
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
                rho0 = -s_.omega * s_.rho0
                alpha = s_.alpha
                alive = jnp.bool_(True)  # no dead scalar met yet this cycle

                # cycle-local Krylov vectors; index 0 aliases the carry.
                # Every committed update below is predicated on the step's
                # liveness, so when a scalar dies at step j the pair
                # (z, rs[0]) freezes at the j-step boundary, where
                # rs[0] = r_init − (A∘M)·z holds exactly.
                rs = [s_.r] + [None] * l
                us = [s_.u] + [None] * l
                z = s_.z

                # ρ₁ of the first BiCG step must be a fresh dot (r₀ was
                # rewritten by the previous MR step); subsequent steps take
                # it fused from the r-matvec below.
                rho1 = conj_dot(s_.rt, rs[0], axis_name)

                # ---- BiCG half: ℓ steps, unrolled (static l)
                for j in range(l):
                    step_ok = jnp.abs(rho0) > brk_tol
                    beta = alpha * (rho1 / jnp.where(step_ok, rho0, one))
                    rho0_n = rho1
                    us_n = [axpy(-beta, us[i], rs[i]) for i in range(j + 1)]
                    # u_{j+1} = A·M·u_j with γ = ⟨r̃₀, u_{j+1}⟩ fused in-pass
                    _, u_next, gamma = mv_prec_wdot(
                        A, M, us_n[j], s_.rt, axis_name
                    )
                    step_ok = step_ok & (jnp.abs(gamma) > brk_tol)
                    alpha_n = rho0_n / jnp.where(step_ok, gamma, one)
                    uall = us_n + [u_next]
                    rs_n = [
                        axpy(-alpha_n, uall[i + 1], rs[i]) for i in range(j + 1)
                    ]
                    # r_{j+1} = A·M·r_j; for j < ℓ−1 the fused dot IS the
                    # next step's ρ₁ = ⟨r̃₀, r_{j+1}⟩ (r_{j+1} is untouched
                    # until then); the last one is unused (free in-pass).
                    _, r_next, rho1_n = mv_prec_wdot(
                        A, M, rs_n[j], s_.rt, axis_name
                    )
                    ok_step = alive & step_ok
                    for i in range(j + 1):
                        us[i] = jnp.where(ok_step, us_n[i], us[i])
                        rs[i] = jnp.where(ok_step, rs_n[i], rs[i])
                    us[j + 1] = u_next  # read only while later steps live
                    rs[j + 1] = r_next
                    z = jnp.where(ok_step, axpy(alpha_n, us_n[0], z), z)
                    rho0 = jnp.where(ok_step, rho0_n, rho0)
                    alpha = jnp.where(ok_step, alpha_n, alpha)
                    rho1 = rho1_n
                    alive = ok_step

                # ---- MR half: modified Gram–Schmidt over r₁..r_ℓ, then the
                # ℓ-dimensional residual minimization (Sleijpen–Fokkema).
                # Runs only on a fully live BiCG half; its own dead σ also
                # abandons the cycle (boundary = end of the BiCG half).
                mr_ok = alive
                tau = [[None] * (l + 1) for _ in range(l + 1)]
                sigma = [None] * (l + 1)
                gamma_p = [None] * (l + 1)
                rm = list(rs)  # MGS-modified copies, committed only if mr_ok
                for j in range(1, l + 1):
                    for i in range(1, j):
                        tau[i][j] = conj_dot(rm[i], rm[j], axis_name) / sigma[i]
                        rm[j] = axpy(-tau[i][j], rm[i], rm[j])
                    sigma[j] = conj_dot(rm[j], rm[j], axis_name)
                    mr_ok = mr_ok & (jnp.abs(sigma[j]) > brk_tol)
                    sigma[j] = jnp.where(mr_ok, sigma[j], one)
                    gamma_p[j] = conj_dot(rm[j], rm[0], axis_name) / sigma[j]

                gamma = [None] * (l + 1)
                gamma[l] = gamma_p[l]
                omega = gamma[l]
                for j in range(l - 1, 0, -1):
                    acc = gamma_p[j]
                    for i in range(j + 1, l + 1):
                        acc = acc - tau[j][i] * gamma[i]
                    gamma[j] = acc
                gamma_pp = [None] * l
                for j in range(1, l):
                    acc = gamma[j + 1]
                    for i in range(j + 1, l):
                        acc = acc + tau[j][i] * gamma[i + 1]
                    gamma_pp[j] = acc

                mr_ok = mr_ok & jnp.isfinite(jnp.abs(omega))
                z_mr = axpy(gamma[1], rm[0], z)
                r_mr = axpy(-gamma_p[l], rm[l], rm[0])
                u_mr = axpy(-gamma[l], us[l], us[0])
                for j in range(1, l):
                    u_mr = axpy(-gamma[j], us[j], u_mr)
                    z_mr = axpy(gamma_pp[j], rm[j], z_mr)
                    r_mr = axpy(-gamma_p[j], rm[j], r_mr)

                completed = mr_ok
                z = jnp.where(completed, z_mr, z)
                r_new = jnp.where(completed, r_mr, rs[0])
                r_norm_new = norm2(r_new, axis_name)

                # incomplete cycle ⇒ shadow restart from the boundary
                # iterate: r̃₀ ← r₀, u₀ ← 0, (ρ₀, α, ω) ← (1, 0, 1); two in a
                # row without a completed cycle is a genuine breakdown.
                rcount = jnp.where(completed, jnp.int32(0), s_.rcount + 1)
                # a second consecutive dead cycle is a breakdown ONLY if the
                # boundary iterate hasn't already converged — with a
                # near-exact M the solve finishes inside the first inner
                # step and every later scalar sits below the rounding floor
                broke = (~completed) & (rcount >= 2) & (r_norm_new > tol2)
                return _State(
                    z=z,
                    r=r_new,
                    u=jnp.where(completed, u_mr, jnp.zeros_like(u_mr)),
                    rt=jnp.where(completed, s_.rt, r_new),
                    rho0=jnp.where(completed, rho0, one),
                    alpha=jnp.where(completed, alpha, jnp.zeros((), T)),
                    omega=jnp.where(completed, omega, one),
                    r_norm=r_norm_new,
                    rcount=rcount,
                    its=s_.its + 1,
                    status=jnp.where(
                        broke, jnp.int32(Status.BREAKDOWN), s_.status
                    ),
                    res=jnp.where(broke, r_norm_new / rhs_norm, s_.res),
                    hist=s_.hist,
                )

            final = lax.while_loop(cond_fn, body_fn, st0)

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
                final.status == Status.RUNNING,
                final.r_norm / rhs_norm,
                final.res,
            )
            x = axpy(one, M.matvec(final.z), x0)  # x = x0 + M·z
            hist = final.hist
            if hist_len:
                hist = jnp.where(
                    converged_exit,
                    hist.at[final.its].set(final.r_norm / rhs_norm),
                    hist,
                )
            return x, make_info(final.its, res, status), hist

        return lax.cond(r0_norm <= tol2, early_converged, iterate, None)

    x, info, hist = _guard3(b, x0, main, axis_name, hist_len, rdt)
    if record_residuals:
        return x, info, hist
    return x, info
