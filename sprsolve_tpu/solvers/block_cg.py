"""Block (multi-RHS) solvers: block CG and a vmap batching adapter.

No reference counterpart (the reference solves one rhs at a time,
``src/bicg_stab.rs:41``); added because multiple right-hand sides move a
memory-bound sparse solver's balance point decisively in its favor:

- **SpMM instead of SpMV**: the matrix (the dominant HBM traffic) is read
  once per iteration for all k right-hand sides, so arithmetic intensity
  grows ~linearly in k until the x/y traffic catches up.
- **Gram reductions instead of dots**: every inner product of classical CG
  becomes a (k, n)·(n, k) matmul and the scalar α/β become
  k×k triangular solves, negligible for the k ≲ 64 this is meant for.
- **Shared Krylov information**: block CG (O'Leary 1980) searches the sum
  of the k Krylov spaces, so ill-conditioned systems converge in *fewer*
  iterations than k independent CG runs, on top of the bandwidth win.

``block_cg`` follows this package's solver conventions (``lax.while_loop``
carry, status codes, ``axis_name`` for row-partitioned distributed operators
— the k×k Gram matrices are psum-reduced, everything else stays local).

``batched`` is the generality fallback: it vmaps any functional solver of
this package over the rhs axis (lockstep while_loop with per-column
predication — JAX's batching of ``while``/``cond``), trading the SpMM
bandwidth win for full method generality (BiCGStab/MINRES/GMRES per column).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..vecalg import eps_for
from .common import make_info


def _apply_M(M, R):
    """Column-wise preconditioner apply on an (n, k) block."""
    if M is None:
        return R
    if hasattr(M, "matmat"):
        return M.matmat(R)
    return jax.vmap(M.matvec, in_axes=1, out_axes=1)(R)


def _matmat(A, X):
    """A·X for an (n, k) block; falls back to vmapping matvec."""
    if hasattr(A, "matmat"):
        return A.matmat(X)
    return jax.vmap(A.matvec, in_axes=1, out_axes=1)(X)


class _State(NamedTuple):
    X: jax.Array        # (n, k)
    R: jax.Array        # (n, k)
    P: jax.Array        # (n, k)
    Z: jax.Array        # (n, k)
    rn: jax.Array       # (k,) real column norms of R
    its: jax.Array
    status: jax.Array


def block_cg(
    A,
    B: jax.Array,
    X0: Optional[jax.Array] = None,
    *,
    M=None,
    tol,
    max_iter,
    axis_name: Optional[str] = None,
):
    """Solve SPD A·X = B for an (n, k) block of right-hand sides.

    Returns ``(X, SolveInfo)`` with scalar info: ``iterations`` is the loop
    count (the max over columns — columns share iterations by construction),
    ``residual`` the worst per-column relative residual, and ``status``
    CONVERGED only when every column converged.

    The k×k normal matrix Pᴴ·A·P is solved with a jitter of
    ``ε·mean(|diag|)`` for robustness as columns converge and the block
    loses rank (the standard alternative — deflation — needs dynamic shapes,
    which XLA does not trace; the jitter keeps the converged columns inert
    at the cost of nothing measurable on the active ones).
    """
    B = jnp.asarray(B)
    if B.ndim != 2:
        raise ValueError("block_cg expects B of shape (n, k)")
    n, k = B.shape
    if X0 is None:
        X0 = jnp.zeros_like(B)

    T = B.dtype
    rdt = jnp.finfo(T).dtype if not jnp.iscomplexobj(B) else jnp.real(B).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(T)
    eye = jnp.eye(k, dtype=T)

    def _colnorms(R):
        s = jnp.sum(jnp.abs(R) ** 2, axis=0)
        if axis_name is not None:
            s = lax.psum(s, axis_name)
        return jnp.sqrt(s).astype(rdt)

    # HIGHEST precision: a default-precision f32 matmul may run in TF32,
    # ~1e-2 relative error in million-row Gram/update matmuls (same fix as
    # lobpcg/gmres)
    _hp = jax.lax.Precision.HIGHEST

    def _gram(U, V):
        """(k, k) = Uᴴ·V — one matmul (+ psum when row-partitioned)."""
        G = jnp.matmul(jnp.conj(U.T), V, precision=_hp)
        if axis_name is not None:
            G = lax.psum(G, axis_name)
        return G

    bn = _colnorms(B)
    # zero-rhs columns count as converged with x = 0 (reference early-out
    # semantics, src/bicg_stab.rs:56-60, applied per column)
    thresholds = tol * jnp.maximum(bn, jnp.asarray(jnp.finfo(rdt).tiny, rdt))

    R = B - _matmat(A, X0)
    Z = _apply_M(M, R)
    st0 = _State(
        X=X0, R=R, P=Z, Z=Z,
        rn=_colnorms(R),
        its=jnp.int32(0),
        status=jnp.int32(Status.RUNNING),
    )

    def cond_fn(s: _State):
        return (
            (s.status == Status.RUNNING)
            & (s.its < max_iter)
            & jnp.any(s.rn > thresholds)
        )

    def body_fn(s: _State):
        Q = _matmat(A, s.P)                      # SpMM: A read once for k rhs
        S = _gram(s.P, Q)                        # Pᴴ·A·P
        jitter = eps * jnp.mean(jnp.abs(jnp.diagonal(S)))
        S = S + jitter.astype(T) * eye
        # α, β via one factorization of S (k×k — negligible)
        PR = _gram(s.P, s.R)
        alpha = jnp.linalg.solve(S, PR)
        X = s.X + jnp.matmul(s.P, alpha, precision=_hp)
        R = s.R - jnp.matmul(Q, alpha, precision=_hp)
        Z = _apply_M(M, R)
        beta = -jnp.linalg.solve(S, _gram(Q, Z))
        P = Z + jnp.matmul(s.P, beta, precision=_hp)
        # non-PD detection: diagonal of the (jittered) Gram must stay positive
        ok = jnp.all(jnp.real(jnp.diagonal(S)) > 0)
        return _State(
            X=jnp.where(ok, X, s.X),
            R=jnp.where(ok, R, s.R),
            P=P, Z=Z,
            rn=jnp.where(ok, _colnorms(R), s.rn),
            its=jnp.where(ok, s.its + 1, s.its),
            status=jnp.where(ok, s.status, jnp.int32(Status.BREAKDOWN)),
        )

    final = lax.while_loop(cond_fn, body_fn, st0)
    all_conv = jnp.all(final.rn <= thresholds)
    status = jnp.where(
        (final.status == Status.RUNNING) & all_conv,
        jnp.int32(Status.CONVERGED),
        jnp.where(
            final.status == Status.RUNNING,
            jnp.int32(Status.INSUFFICIENT_ITER),
            final.status,
        ),
    )
    res = jnp.max(final.rn / jnp.maximum(bn, jnp.asarray(1.0, rdt) * eps))
    return final.X, make_info(final.its, res, status)


def batched(solver):
    """Lift a single-rhs functional solver to an (n, k) block of rhs.

    ``batched(bicgstab)(A, B, X0, **kw)`` vmaps the solver over the column
    axis: the while_loops run in lockstep with per-column predication, the
    operator is closed over (not batched), and the returned ``SolveInfo``
    carries *per-column* ``iterations``/``residual``/``status`` arrays of
    shape (k,).  Use :func:`block_cg` for SPD systems (shared Krylov space +
    SpMM bandwidth); use this for method generality.

    CAVEAT — lockstep overrun: under ``vmap`` a ``while_loop`` body keeps
    executing for EVERY column until the slowest one finishes.  For
    minimizing recurrences (cg, minres) the extra iterations are benign
    (the iterate keeps improving; its/status are already predicated), and
    :func:`~sprsolve_tpu.solvers.cocg.cocg` freezes each column at its own
    exit (its non-minimizing recurrence *wanders* after convergence —
    found the hard way by the rational filter's batched inner solves,
    round 5).  Other oscillating short recurrences (bicgstab, cgs, idrs)
    are NOT frozen: their reported per-column residual is still honest
    (it is re-measured at exit), but a strong iteration-count imbalance
    across columns can degrade the early finishers' iterates in f32 —
    prefer per-column solves or cg/minres/cocg when columns differ wildly.
    """

    def run(A, B, X0=None, **kwargs):
        B = jnp.asarray(B)
        if B.ndim != 2:
            raise ValueError("batched solver expects B of shape (n, k)")
        if X0 is None:
            X0 = jnp.zeros_like(B)

        def one(b, x0):
            return solver(A, b, x0, **kwargs)

        return jax.vmap(one, in_axes=(1, 1), out_axes=(1, 0))(B, X0)

    return run
