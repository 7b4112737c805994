"""CS-MINRES: MINRES for complex-*symmetric* (Aᵀ = A, non-Hermitian) systems
via the Saunders process.

Re-design of ``src/cs_minres.rs``.  Differences from plain MINRES,
replicated exactly (``src/cs_minres.rs:97-146``):

- the Krylov step multiplies A·conj(q_k) (``:99-102``),
- α = conj(q_k)·(A·conj(q_k)) (``:103``),
- modified Givens rotation with conjugated cosines: tr = c̄_old·β (``:120``),
  r1̂ = c̄·α − tr·s (``:122``), new cosine c = r1̂̄·r1_inv (``:133``),
- the p-recurrence is seeded from conj(q_k) (``:141-146``).

The reference exports this solver but never exercises it in an active test
(``tests/test_minres.rs:14-15``); this framework fixes that gap —
see ``tests/test_complex_solve2.py``.

**Preconditioned variant (beyond the reference).** ``src/cs_minres.rs`` has
no precond form; here the MINRES preconditioning structure
(``src/minres.rs:178-341``) is adapted to the Saunders process.  ``M`` must
apply a **real symmetric positive** M⁻¹ (e.g. a real-diagonal Jacobi — the
reference itself uses real diagonals on complex systems,
``src/precond.rs:6-13``; for complex diagonals use |d|, Freund's standard
choice): with M⁻¹ = E·Eᵀ and E real, the split-preconditioned operator
E·A·Eᵀ stays complex-symmetric, so the same conjugated recurrence applies
with the M⁻¹-image chain w = M⁻¹·v:

    u        = A·conj(w_k)            (one fused two-plane kernel pass)
    α        = conj_dot(w_k, u)
    v̂_{k+1}β = u − α·v̂_k − β·v̂_{k-1}
    β²       = conj_dot(v̂_{k+1}, M⁻¹·v̂_{k+1})   (> 0 gate, src/minres.rs:235-244)
    p        seeded from conj(w_k)

With M = I this reduces bitwise to the unpreconditioned path (w ≡ v).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..ops.operator import mv_conj_dot
from ..vecalg import abs2, axpy, conj, conj_dot, eps_for, norm2, rscale
from .common import check_shapes, make_info


class _State(NamedTuple):
    x: jax.Array
    v: jax.Array
    v_new: jax.Array
    w_new: jax.Array     # M⁻¹-image of v_new (precond only; zeros otherwise)
    p: jax.Array
    p_old: jax.Array
    beta_new: jax.Array  # real
    c: jax.Array         # T
    c_old: jax.Array     # T
    s: jax.Array         # real
    s_old: jax.Array     # real
    eta: jax.Array       # T
    res_norm: jax.Array  # real
    its: jax.Array
    status: jax.Array
    res: jax.Array
    hist: jax.Array


def cs_minres(
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
    """Solve A·x = b for complex-symmetric A. Returns ``(x, SolveInfo)``,
    plus the residual trace when ``record_residuals=True`` (static max_iter).

    ``M`` (optional) applies a real symmetric-positive M⁻¹ — see the module
    docstring for the validity requirement and the β² > 0 runtime gate.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    has_precond = M is not None

    T = b.dtype
    rdt = jnp.finfo(T).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    hist_len = int(max_iter) if record_residuals else 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(b.dtype)
    one_t = jnp.ones((), T)
    zero_r = jnp.zeros((), rdt)

    def _beta_gate(beta_new2, noise_scale):
        # β² = v̂ᴴM⁻¹v̂ must be real positive for a valid real-SPD M⁻¹.
        # Negative real parts flag INVALID whenever they are significant
        # against the fp noise floor of the computation (ε · noise_scale,
        # where noise_scale is the previous step's β², or the rhs M-norm²
        # at init — the magnitude of the terms the dot sums).  The imag
        # test is relative to max(|re|, noise_scale) so it neither trips on
        # cancellation noise at lucky breakdown nor misses a genuinely
        # complex β² at problem scale.  β² within ±ε·noise_scale of zero
        # passes and is absorbed by the guarded 1/β below (s_sin → 0 → the
        # residual recurrence collapses to convergence).
        re2 = jnp.real(beta_new2)
        return (re2 < -eps * noise_scale) | (
            jnp.abs(jnp.imag(beta_new2))
            > eps * jnp.maximum(jnp.abs(re2), noise_scale)
        )

    def main(rhs_norm):
        v_new = axpy(-one_t, A.matvec(x0), b)  # r₁ = b − A·x
        zeros = jnp.zeros_like(b)

        if has_precond:
            # Preconditioned residual tracking: the Givens sines contract
            # the TRANSFORMED system's residual, so the recurrence must
            # start from (and the threshold be expressed in) the M⁻¹-norm —
            # mixing the 2-norm of r with M-norm sines would mis-report the
            # residual by up to sqrt(κ(M)).  Reported residual is the
            # RELATIVE M⁻¹-norm: ‖r‖_{M⁻¹} / ‖b‖_{M⁻¹}.
            wb = M.matvec(b)
            beta_b2 = conj_dot(b, wb, axis_name)
            w_new = M.matvec(v_new)
            beta_new2 = conj_dot(v_new, w_new, axis_name)
            # the rhs gate is self-relative — for a valid SPD M⁻¹ and b ≠ 0
            # (guaranteed by the caller guard) its real part must dominate;
            # re(bᴴM⁻¹b) ≤ 0 also covers the semidefinite-M case where the
            # M-norm denominator would vanish (threshold 0, res = inf)
            re_b = jnp.real(beta_b2)
            bad0 = (
                _beta_gate(beta_new2, re_b)
                | (re_b <= 0)
                | (jnp.abs(jnp.imag(beta_b2)) > eps * re_b)
            )
            denom = jnp.sqrt(jnp.maximum(re_b, 0))
            beta_new0 = jnp.sqrt(jnp.maximum(jnp.real(beta_new2), 0))
            # conservative estimate |β²|^½ (≈ β₁ for valid M): a clamped
            # negative β² then reports its magnitude instead of 0.0 and can
            # never trigger the early-converged exit spuriously
            res_norm0 = jnp.sqrt(jnp.abs(beta_new2))
            ts = jnp.where(
                beta_new0 > 0, jnp.ones((), rdt) / beta_new0,
                jnp.zeros((), rdt),
            )
            v1 = rscale(ts, v_new)
            w1 = rscale(ts, w_new)
        else:
            bad0 = jnp.zeros((), jnp.bool_)
            res_norm0 = norm2(v_new, axis_name)
            denom = rhs_norm
            beta_new0 = res_norm0
            # guarded init division: a warm start at the exact solution has
            # r₁ = 0 → β₁ = 0; the early-converged exit below returns before
            # any iteration, and the zero scale keeps NaN out of the trace
            ts0 = jnp.where(
                beta_new0 > 0, jnp.ones((), rdt) / beta_new0,
                jnp.zeros((), rdt),
            )
            v1 = rscale(ts0, v_new)
            w1 = zeros
        beta_one = beta_new0
        threshold = tol * denom

        st0 = _State(
            x=x0, v=zeros, v_new=v1, w_new=w1, p=zeros, p_old=zeros,
            beta_new=beta_new0,
            c=one_t, c_old=one_t, s=zero_r, s_old=zero_r, eta=one_t,
            res_norm=res_norm0,
            its=jnp.int32(0),
            status=jnp.where(
                bad0,
                jnp.int32(Status.INVALID_PRECONDITIONER),
                jnp.int32(Status.RUNNING),
            ),
            res=zero_r,
            hist=jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

        def cond_fn(s_):
            return (s_.status == Status.RUNNING) & (s_.its < max_iter)

        def body_fn(s_):
            beta = s_.beta_new
            v_old, v = s_.v, s_.v_new
            w = s_.w_new if has_precond else v

            # A·conj(q_k) and α = conj(q_k)·(A·conj(q_k)) in one operator
            # pass where supported (the two-plane kernel folds the
            # conjugation and the dot into the SpMV; src/cs_minres.rs:99-103).
            # Preconditioned: the same step on the M⁻¹-image w.
            tvec = conj(w)                      # seeds p below
            v_new, alpha = mv_conj_dot(A, w, axis_name)
            v_new = axpy((-beta).astype(T), v_old, v_new)
            v_new = axpy(-alpha, v, v_new)

            if has_precond:
                w_tmp = M.matvec(v_new)
                beta_new2 = conj_dot(v_new, w_tmp, axis_name)
                # β-positivity gate adapted from src/minres.rs:278-287
                # (scale-free form — see _beta_gate); the reference returns
                # Err before touching x, so the rotation and update are
                # skipped on the bad branch.
                bad = _beta_gate(beta_new2, beta * beta)
                beta_new = jnp.sqrt(jnp.maximum(jnp.real(beta_new2), 0))
            else:
                bad = jnp.zeros((), jnp.bool_)
                w_tmp = s_.w_new
                beta_new = norm2(v_new, axis_name)

            def rotate_and_update(s_):
                # guarded 1/β: β = 0 is exact (lucky) breakdown — the zero
                # scale makes s_sin = 0, so res_norm collapses and the next
                # check reports convergence instead of producing inf/NaN
                ts = jnp.where(
                    beta_new > 0, jnp.ones((), rdt) / beta_new,
                    jnp.zeros((), rdt),
                )
                vn = rscale(ts, v_new)
                wn = rscale(ts, w_tmp) if has_precond else w_tmp

                # modified Givens with c / c̄ entries (src/cs_minres.rs:109-134)
                r3 = s_.s_old * beta
                tr = jnp.conj(s_.c_old) * beta
                r2 = alpha * s_.s + s_.c * tr
                r1_hat = jnp.conj(s_.c) * alpha - tr * s_.s
                r1_inv = jnp.ones((), rdt) / jnp.sqrt(
                    abs2(r1_hat) + beta_new * beta_new
                )

                c_old, s_old = s_.c, s_.s
                c = jnp.conj(r1_hat) * r1_inv
                s_sin = beta_new * r1_inv

                # p seeded from conj(q_k) (src/cs_minres.rs:141-146);
                # preconditioned: from conj(w_k), the Saunders analog of
                # MINRES's w-seeded directions (src/minres.rs:324-329)
                p_new = tvec
                p_new = axpy(-r2, s_.p, p_new)
                p_new = axpy((-r3).astype(T), s_.p_old, p_new)
                p_new = rscale(r1_inv, p_new)

                x = axpy((c * s_.eta) * beta_one, p_new, s_.x)

                res_norm = s_.res_norm * jnp.abs(s_sin)
                converged = res_norm < threshold
                eta = s_.eta * (-s_sin)

                hist = s_.hist
                if hist_len:
                    hist = hist.at[s_.its].set(res_norm / denom)

                return _State(
                    x=x, v=v, v_new=vn, w_new=wn,
                    p=p_new, p_old=s_.p,
                    beta_new=beta_new,
                    c=c, c_old=c_old, s=s_sin, s_old=s_old, eta=eta,
                    res_norm=res_norm,
                    its=jnp.where(converged, s_.its, s_.its + 1),
                    status=jnp.where(
                        converged, jnp.int32(Status.CONVERGED), s_.status
                    ),
                    res=jnp.where(converged, res_norm / denom, s_.res),
                    hist=hist,
                )

            if has_precond:
                return lax.cond(
                    bad,
                    lambda s_: s_._replace(
                        status=jnp.int32(Status.INVALID_PRECONDITIONER)
                    ),
                    rotate_and_update,
                    s_,
                )
            return rotate_and_update(s_)

        def run(_):
            final = lax.while_loop(cond_fn, body_fn, st0)
            status = jnp.where(
                final.status == Status.RUNNING,
                jnp.int32(Status.INSUFFICIENT_ITER),
                final.status,
            )
            res = jnp.where(
                final.status == Status.RUNNING,
                final.res_norm / denom,
                final.res,
            )
            return final.x, make_info(final.its, res, status), final.hist

        def early(_):
            # already converged at entry (e.g. warm start at the solution):
            # return before the first 1/β — denom > 0 whenever ¬bad0
            hist = jnp.full(hist_len, jnp.nan, dtype=rdt)
            if hist_len:
                hist = hist.at[0].set(res_norm0 / denom)
            return x0, make_info(0, res_norm0 / denom, Status.CONVERGED), hist

        return lax.cond(
            (res_norm0 <= threshold) & ~bad0, early, run, None
        )

    from .bicgstab import _guard3

    x, info, hist = _guard3(b, x0, main, axis_name, hist_len, rdt)
    if record_residuals:
        return x, info, hist
    return x, info
