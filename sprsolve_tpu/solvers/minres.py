"""MINRES for real-symmetric / complex-Hermitian (possibly indefinite) systems.

Re-design of ``src/minres.rs``: the reference's zero-copy pointer
rotation of the Lanczos vectors (``src/minres.rs:92-96,151-154``) becomes plain
carry re-binding in the while_loop state (free under XLA with donation); the
fused SpMV+dot ``mul_vec_dot`` (``:116``) maps to the operator's
``matvec_dot`` which XLA fuses into one pass.

Numerical structure replicated exactly for iteration parity:

- Lanczos recurrence in the Wiki-stable order: v₊ = A·q − β·q₋ − α·q with
  α = qᴴ(A·q) computed *before* the orthogonalization (``:112-118``).
- Givens-rotation QR of the tridiagonal (``:123-148``), with |r1̂|² via the
  cauchy ``square()`` = squared modulus.
- Recurrence-estimated residual: res ← res·|s| each step, *strict* <
  threshold test at the end of the body (``:164-168``); no true-residual
  check — iteration counts are 0-based (first pass returns 0).
- Preconditioned variant (M ≈ (CᴴC)⁻¹ apply): β² = rᴴ·M⁻¹r positivity gate
  ``re < ε || im > ε·re`` → InvalidPreconditioner (``:235-244,278-287``).

Residual-semantics caveat (REFERENCE PARITY, kept deliberately): the
preconditioned variant seeds the recurrence with the 2-norm ‖r₀‖ but the
Givens sines contract the *transformed* system's residual, so the reported
estimate mixes norms and can deviate from the true relative residual by up
to ~√κ(M) on badly scaled preconditioners — exactly as in
``src/minres.rs:178-341``, whose iteration counts these tests pin.  For a
norm-consistent estimate use :func:`~sprsolve_tpu.solvers.cs_minres`'s
preconditioned form (which tracks ‖r‖_{M⁻¹} throughout) as the model, or
verify with a true-residual check / :func:`~sprsolve_tpu.solvers.refine`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..vecalg import abs2, axpy, conj_dot, eps_for, norm2, rscale
from .common import check_shapes, make_info


class _State(NamedTuple):
    x: jax.Array
    v: jax.Array        # q_k   (becomes v_old at loop top)
    v_new: jax.Array    # q_k+1 (becomes v at loop top)
    w: jax.Array        # M⁻¹-image chain (precond only; zeros otherwise)
    w_new: jax.Array
    p: jax.Array
    p_old: jax.Array
    beta_new: jax.Array  # real
    c: jax.Array         # T
    c_old: jax.Array     # T
    s: jax.Array         # real
    s_old: jax.Array     # real
    eta: jax.Array       # T
    res_norm: jax.Array  # real (recurrence estimate, absolute)
    its: jax.Array
    status: jax.Array
    res: jax.Array       # relative residual at termination
    hist: jax.Array      # (max_iter,) per-iteration recurrence residuals, or (0,)


def minres(
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
    """Solve A·x = b with MINRES (A symmetric/Hermitian, may be indefinite).

    Like the reference (``src/minres.rs:11``), symmetry is not checked.
    Returns ``(x, SolveInfo)``; with ``record_residuals=True`` (static
    ``max_iter`` required) also the per-iteration recurrence-residual trace
    (relative, NaN beyond termination) as a third output.
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
        # β² = rᴴM⁻¹r must be real positive for a valid SPD M.  The
        # reference's absolute-ε test (src/minres.rs:258-264) cannot tell
        # an invalid M from LUCKY breakdown: with a near-exact M the
        # Lanczos process terminates after one step and β² lands at
        # cancellation-noise scale (±ε·previous-β²), which the absolute
        # test flags as invalid.  Same self-relative form as cs_minres's
        # gate: negative real parts and imaginary parts flag INVALID only
        # when significant against the fp noise floor of the dot
        # (ε · noise_scale); |β²| within the floor passes and the guarded
        # 1/β below collapses the residual recurrence to convergence.
        re2 = jnp.real(beta_new2)
        return (re2 < -eps * noise_scale) | (
            jnp.abs(jnp.imag(beta_new2))
            > eps * jnp.maximum(jnp.abs(re2), noise_scale)
        )

    def main(rhs_norm):
        threshold = tol * rhs_norm

        # v_new = b − A·x  (r₁, src/minres.rs:76-80)
        v_new = axpy(-one_t, A.matvec(x0), b)
        res_norm0 = norm2(v_new, axis_name)

        zeros = jnp.zeros_like(b)
        if has_precond:
            w_new = M.matvec(v_new)
            beta_new2 = conj_dot(v_new, w_new, axis_name)
            # noise floor of the init dot: ε·‖r₁‖·‖M⁻¹r₁‖ (the magnitude
            # of the summed terms; one extra norm2, init only)
            noise0 = res_norm0 * norm2(w_new, axis_name)
            bad0 = _beta_gate(beta_new2, noise0)
            beta_new0 = jnp.sqrt(jnp.maximum(jnp.real(beta_new2), 0))
            # guarded init scale: β₁ = 0 with r₁ = 0 is a warm start at the
            # exact solution (cond exits before any iteration)
            ts = jnp.where(
                beta_new0 > 0, jnp.ones((), rdt) / beta_new0, zero_r
            )
            v1 = rscale(ts, v_new)
            w1 = rscale(ts, w_new)
        else:
            bad0 = jnp.zeros((), jnp.bool_)
            beta_new0 = res_norm0
            v1 = rscale(jnp.ones((), rdt) / beta_new0, v_new)
            w1 = zeros
        beta_one = beta_new0

        st0 = _State(
            x=x0,
            v=zeros, v_new=v1, w=zeros, w_new=w1,
            p=zeros, p_old=zeros,
            beta_new=beta_new0,
            c=one_t, c_old=one_t,
            s=zero_r, s_old=zero_r,
            eta=one_t,
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

            # α = (conj q)·(A·q) fused with the SpMV (src/minres.rs:116 / :271)
            v_new, alpha = A.matvec_dot(w)
            if axis_name is not None:
                alpha = lax.psum(alpha, axis_name)

            v_new = axpy((-beta).astype(T), v_old, v_new)
            v_new = axpy(-alpha, v, v_new)

            if has_precond:
                w_new = M.matvec(v_new)
                beta_new2 = conj_dot(v_new, w_new, axis_name)
                # β-positivity gate (src/minres.rs:278-287) in the
                # self-relative form (see _beta_gate; noise scale = the
                # previous step's β², free) — the reference returns Err
                # *before* touching x, so the rotation/update is skipped
                # on the bad branch; lucky breakdown passes and converges.
                bad = _beta_gate(beta_new2, beta * beta)
                beta_new = jnp.sqrt(jnp.maximum(jnp.real(beta_new2), 0))
            else:
                beta_new = norm2(v_new, axis_name)
                w_new = s_.w_new

            def rotate_and_update(s_):
                # guarded 1/β: β = 0 is exact (lucky) breakdown — the zero
                # scale makes s_sin = 0, so res_norm collapses and the next
                # check reports convergence instead of producing inf/NaN
                ts = jnp.where(
                    beta_new > 0, jnp.ones((), rdt) / beta_new, zero_r
                )
                vn = rscale(ts, v_new)
                wn = rscale(ts, w_new) if has_precond else w_new

                # --- Givens rotation on the tridiagonal (src/minres.rs:123-148)
                r3 = s_.s_old * beta
                tr = s_.c_old * beta
                r2 = alpha * s_.s + s_.c * tr
                r1_hat = s_.c * alpha - tr * s_.s
                r1_inv = jnp.ones((), rdt) / jnp.sqrt(
                    abs2(r1_hat) + beta_new * beta_new
                )

                c_old, s_old = s_.c, s_.s
                c = r1_hat * r1_inv
                s_sin = beta_new * r1_inv

                # p-recurrence (src/minres.rs:151-160); seeded from q_k
                # (preconditioned: from the M⁻¹-image w, src/minres.rs:324-329)
                p_new = w if has_precond else v
                p_new = axpy(-r2, s_.p, p_new)
                p_new = axpy((-r3).astype(T), s_.p_old, p_new)
                p_new = rscale(r1_inv, p_new)

                x = axpy((c * s_.eta) * beta_one, p_new, s_.x)

                res_norm = s_.res_norm * jnp.abs(s_sin)
                converged = res_norm < threshold
                eta = s_.eta * (-s_sin)

                hist = s_.hist
                if hist_len:
                    hist = hist.at[s_.its].set(res_norm / rhs_norm)

                return _State(
                    x=x,
                    v=v, v_new=vn,
                    w=w if has_precond else s_.w, w_new=wn,
                    p=p_new, p_old=s_.p,
                    beta_new=beta_new,
                    c=c, c_old=c_old,
                    s=s_sin, s_old=s_old,
                    eta=eta,
                    res_norm=res_norm,
                    its=jnp.where(converged, s_.its, s_.its + 1),
                    status=jnp.where(
                        converged, jnp.int32(Status.CONVERGED), s_.status
                    ),
                    res=jnp.where(converged, res_norm / rhs_norm, s_.res),
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

        final = lax.while_loop(cond_fn, body_fn, st0)
        status = jnp.where(
            final.status == Status.RUNNING,
            jnp.int32(Status.INSUFFICIENT_ITER),
            final.status,
        )
        res = jnp.where(
            final.status == Status.RUNNING,
            final.res_norm / rhs_norm,
            final.res,
        )
        return final.x, make_info(final.its, res, status), final.hist

    from .bicgstab import _guard3

    x, info, hist = _guard3(b, x0, main, axis_name, hist_len, rdt)
    if record_residuals:
        return x, info, hist
    return x, info
