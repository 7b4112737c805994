"""LSQR: damped least-squares / rectangular systems (Paige & Saunders 1982).

Not present in the reference (its solvers are square-system Krylov methods,
``src/lib.rs:15-21``); added for framework completeness — LSQR is the
standard sparse least-squares method (cf. ``scipy.sparse.linalg.lsqr``) and
the natural consumer of the operator-adjoint surface
(:meth:`~sprsolve_tpu.sparse.containers.CSR.adjoint`).

Solves ``min ‖A·x − b‖²  + damp²·‖x‖²`` for any m×n A via Golub–Kahan
bidiagonalization: one ``A`` apply and one ``Aᴴ`` apply per iteration, plus
two norms — all regular vector work, no triangular solves, so it runs at
kernel speed through jit/shard_map like the package's other solvers.  The
adjoint is a *separate operator* (``AH``) built once at setup, mirroring how
the layout optimizer treats A itself: a transposed gather per iteration
would scatter on every iteration, a second CSR in its own layout
is free after construction.

Complex systems are supported; all rotation scalars (α, β, ρ, c, s, φ) are
real norms, so the Givens machinery is real even when the vectors are
complex — same structure as the reference's MINRES (``src/minres.rs:123-148``).

Stopping (simplified ``scipy.sparse.linalg.lsqr`` tests, atol=btol=``tol``):
``‖r‖ ≤ tol·‖b‖`` (consistent systems) or ``‖Aᴴr‖ ≤ tol·‖A‖·‖r‖``
(least-squares convergence; ‖A‖ is the accumulated Frobenius estimate).
Both map to ``Status.CONVERGED``; α/β-breakdown (Krylov space exhausted —
the iterate is exact in exact arithmetic) also exits converged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import IncompatibleMatrixFormat, Status
from ..vecalg import eps_for, norm2
from .common import make_info


class _State(NamedTuple):
    x: jax.Array
    u: jax.Array        # (m,) left Lanczos vector
    v: jax.Array        # (n,) right Lanczos vector
    w: jax.Array        # (n,) search direction
    alpha: jax.Array    # real scalars of the bidiagonalization
    beta: jax.Array
    phibar: jax.Array
    rhobar: jax.Array
    anorm2: jax.Array   # Σ α² + β² + damp²  (‖A‖_F estimate²)
    res2: jax.Array     # Σ ψ² (damping leakage into the residual)
    rnorm: jax.Array    # current ‖r‖ (incl. damping term)
    arnorm: jax.Array   # current ‖Aᴴr‖
    its: jax.Array
    status: jax.Array
    hist: jax.Array


def lsqr(
    A,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    AH=None,
    damp: float = 0.0,
    tol,
    max_iter,
    axis_name: Optional[str] = None,
    record_residuals: bool = False,
):
    """Least-squares solve of m×n ``A``. Returns ``(x, SolveInfo)``.

    ``AH`` is the adjoint operator (Aᴴ); for CSR inputs it defaults to
    ``A.adjoint()`` (host-side build — pass it explicitly when calling under
    ``jax.jit``).  ``b`` has length m, ``x0``/the solution length n.
    ``info.residual`` is ‖r‖/‖b‖ (including the damping term when
    ``damp > 0``).
    """
    if AH is None:
        if not hasattr(A, "adjoint"):
            raise IncompatibleMatrixFormat(
                "lsqr needs the adjoint operator: pass AH= (or use a CSR "
                "container, whose .adjoint() is built automatically)"
            )
        AH = A.adjoint()
    m_dim, n_dim = A.shape
    if b.ndim == 1 and b.shape[0] != m_dim:
        raise IncompatibleMatrixFormat(
            "Input vec dimension doesn't match the matrix size"
        )
    if x0 is not None and x0.ndim == 1 and x0.shape[0] != n_dim:
        raise IncompatibleMatrixFormat(
            "Input and output vec dimension do not match"
        )

    T = b.dtype
    rdt = jnp.real(b).dtype if jnp.iscomplexobj(b) else jnp.finfo(T).dtype
    tol = jnp.asarray(tol, rdt)
    damp_r = jnp.asarray(damp, rdt)
    # +1: the final write lands at hist[its] with its == max_iter when
    # convergence hits exactly at the budget
    hist_len = int(max_iter) + 1 if record_residuals else 0
    max_iter = jnp.asarray(max_iter, jnp.int32)
    eps = eps_for(T)
    one = jnp.ones((), rdt)

    if x0 is None:
        x0 = jnp.zeros((n_dim,), T)

    def _normalize(vec):
        nrm = norm2(vec, axis_name)
        safe = jnp.where(nrm > 0, nrm, one)
        return vec * (one / safe).astype(rdt), nrm

    def main(rhs_norm):
        r0 = b - A.matvec(x0)
        u, beta = _normalize(r0)
        v, alpha = _normalize(AH.matvec(u))
        st = _State(
            x=x0, u=u, v=v, w=v,
            alpha=alpha, beta=beta,
            phibar=beta, rhobar=alpha,
            anorm2=alpha * alpha + damp_r * damp_r,
            res2=jnp.zeros((), rdt),
            rnorm=beta,
            arnorm=alpha * beta,
            its=jnp.int32(0),
            status=jnp.int32(Status.RUNNING),
            hist=jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

        def cond_fn(s_):
            anorm = jnp.sqrt(s_.anorm2)
            small_r = s_.rnorm <= tol * rhs_norm
            small_ar = s_.arnorm <= tol * anorm * s_.rnorm
            return (
                (s_.status == Status.RUNNING)
                & (s_.its < max_iter)
                & ~small_r
                & ~small_ar
            )

        def body_fn(s_):
            if hist_len:
                s_ = s_._replace(
                    hist=s_.hist.at[s_.its].set(s_.rnorm / rhs_norm)
                )
            # continue the bidiagonalization
            u_next = A.matvec(s_.v) - s_.alpha.astype(rdt) * s_.u
            u, beta = _normalize(u_next)
            v_next = AH.matvec(u) - beta.astype(rdt) * s_.v
            v, alpha = _normalize(v_next)
            # α/β = 0 means the Krylov space is exhausted: the current
            # iterate is exact (in exact arithmetic) — exit converged after
            # applying this step's rotation
            exhausted = (beta <= eps) | (alpha <= eps)

            # eliminate the damping row (identity rotation when damp = 0)
            rhobar1 = jnp.sqrt(s_.rhobar**2 + damp_r**2)
            c1 = s_.rhobar / rhobar1
            s1 = damp_r / rhobar1
            psi = s1 * s_.phibar
            phibar_d = c1 * s_.phibar
            # eliminate the subdiagonal β
            rho = jnp.sqrt(rhobar1**2 + beta**2)
            c = rhobar1 / rho
            s = beta / rho
            theta = s * alpha
            rhobar = -c * alpha
            phi = c * phibar_d
            phibar = s * phibar_d
            tau = s * phi

            x = s_.x + (phi / rho) * s_.w
            w = v - (theta / rho).astype(rdt) * s_.w

            anorm2 = s_.anorm2 + alpha * alpha + beta * beta + damp_r * damp_r
            res2 = s_.res2 + psi * psi
            rnorm = jnp.sqrt(phibar * phibar + res2)
            arnorm = alpha * jnp.abs(tau)
            return _State(
                x=x, u=u, v=v, w=w,
                alpha=alpha, beta=beta,
                phibar=phibar, rhobar=rhobar,
                anorm2=anorm2, res2=res2,
                rnorm=rnorm,
                arnorm=jnp.where(exhausted, jnp.zeros((), rdt), arnorm),
                its=s_.its + 1,
                status=s_.status,
                hist=s_.hist,
            )

        final = lax.while_loop(cond_fn, body_fn, st)

        anorm = jnp.sqrt(final.anorm2)
        converged = (
            (final.rnorm <= tol * rhs_norm)
            | (final.arnorm <= tol * anorm * final.rnorm)
        )
        status = jnp.where(
            converged,
            jnp.int32(Status.CONVERGED),
            jnp.int32(Status.INSUFFICIENT_ITER),
        )
        res = final.rnorm / rhs_norm
        hist = final.hist
        if hist_len:
            hist = jnp.where(
                final.its < hist_len,
                hist.at[final.its].set(res),
                hist,
            )
        return final.x, make_info(final.its, res, status), hist

    rhs_norm = norm2(b, axis_name)

    def trivial(_):
        return (
            jnp.zeros((n_dim,), T),
            make_info(0, rhs_norm, Status.CONVERGED),
            jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

    x, info, hist = lax.cond(
        rhs_norm <= eps, trivial, lambda _: main(rhs_norm), None
    )
    if record_residuals:
        return x, info, hist
    return x, info
