"""Gauss-Seidel stationary solver.

Re-design of ``src/gauss_seidel.rs``.  True Gauss-Seidel is
inherently sequential over rows — x[i] reads x[j<i] already updated in the
same sweep (``src/gauss_seidel.rs:111-125``) — which fundamentally conflicts
with data-parallel hardware.  This module therefore provides two sweeps:

- :func:`gauss_seidel` — the *exact* sequential sweep (``lax.fori_loop`` over
  rows on an ELL layout).  Bit-faithful to the reference semantics, used for
  fidelity tests and small systems.  Slow on parallel hardware by
  construction; documented
  deviation: none.
- :func:`gauss_seidel_redblack` (see ``redblack.py``) — multicolor
  reformulation whose sweeps are fully parallel; different (but classical)
  convergence behavior, intended as the practical parallel smoother /
  preconditioner.

Semantics replicated exactly for the sequential path:

- x[i] = (b[i] − Σ_{j≠i} a_ij·x[j]) / a_ii, rows in order (``:111-125``).
- Diagonal must exist and satisfy |a_ii|² ≥ ε, else ZeroDiagonalElem
  (``:72-78``) — structurally-missing diagonals read as 0 and fail the same
  check.
- Convergence: **absolute** residual ‖A·x − b‖ ≤ eps·‖b‖ after every sweep
  (``:87-108,127-137``) — unlike the Krylov solvers this returns the absolute
  norm (``:107``).
- Iteration counting quirk preserved: the first sweep's check returns 1, the
  sweep at loop index ``it`` returns ``it`` (i.e. sweeps − 1 thereafter)
  (``:106-107,135-136``).
- ``max_iter == 0`` → InsufficientIterNum before any work (``:52-54``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import Status
from ..sparse.containers import ELL
from ..vecalg import abs2, axpy, eps_for, norm2
from .common import check_shapes, make_info


class _State(NamedTuple):
    x: jax.Array
    it: jax.Array
    status: jax.Array
    res: jax.Array


def _sweep(A: ELL, diag: jax.Array, b: jax.Array, x: jax.Array) -> jax.Array:
    """One in-order Gauss-Seidel sweep. Sequential by row (true GS)."""
    n = A.shape[0]

    def row_body(i, x):
        cols_i = lax.dynamic_index_in_dim(A.cols, i, keepdims=False)
        vals_i = lax.dynamic_index_in_dim(A.data, i, keepdims=False)
        xs = jnp.take(x, cols_i)
        off_diag = cols_i != i  # pad slots carry value 0 and contribute nothing
        sigma = jnp.sum(jnp.where(off_diag, vals_i * xs, jnp.zeros((), x.dtype)))
        xi = (b[i] - sigma) / diag[i]
        return x.at[i].set(xi)

    return lax.fori_loop(0, n, row_body, x)


def gauss_seidel(
    A: ELL,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    max_iter,
    eps,
    axis_name: Optional[str] = None,
):
    """Solve A·x = b with sequential Gauss-Seidel sweeps.

    ``A`` must be square in ELL layout (convert CSR via ``csr.to_ell()`` —
    the format requirement mirrors the reference's CSR-only check,
    ``src/gauss_seidel.rs:22-26``). Returns ``(x, SolveInfo)`` where the
    residual is **absolute**.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "sequential Gauss-Seidel is single-device; use the red-black "
            "variant for distributed smoothing"
        )
    from ..errors import IncompatibleMatrixFormat

    if A.shape[0] != A.shape[1]:
        raise IncompatibleMatrixFormat("Not a square matrix")
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0)

    rdt = jnp.finfo(b.dtype).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    eps_arg = jnp.asarray(eps, dtype=rdt)
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    machine_eps = eps_for(b.dtype)

    diag = A.diagonal()
    bad_diag = jnp.any(abs2(diag) < machine_eps)  # src/gauss_seidel.rs:72-78

    one_t = jnp.ones((), b.dtype)
    b_norm = norm2(b)
    tol2 = eps_arg * b_norm

    def residual(x):
        return norm2(axpy(-one_t, b, A.matvec(x)))

    def failed_zero_diag(_):
        return x0, make_info(0, jnp.zeros((), rdt), Status.ZERO_DIAGONAL)

    def insufficient(_):
        return x0, make_info(0, jnp.zeros((), rdt), Status.INSUFFICIENT_ITER)

    def run(_):
        # first sweep fused with setup in the reference (src/gauss_seidel.rs:60-86)
        x1 = _sweep(A, diag, b, x0)
        res1 = residual(x1)

        def first_converged(_):
            return x1, make_info(1, res1, Status.CONVERGED)

        def iterate(_):
            st0 = _State(
                x=x1,
                it=jnp.int32(1),
                status=jnp.int32(Status.RUNNING),
                res=res1,
            )

            def cond_fn(s_):
                return (s_.status == Status.RUNNING) & (s_.it < max_iter)

            def body_fn(s_):
                x = _sweep(A, diag, b, s_.x)
                res = residual(x)
                converged = res <= tol2
                return _State(
                    x=x,
                    it=jnp.where(converged, s_.it, s_.it + 1),
                    status=jnp.where(
                        converged, jnp.int32(Status.CONVERGED), s_.status
                    ),
                    res=res,
                )

            final = lax.while_loop(cond_fn, body_fn, st0)
            status = jnp.where(
                final.status == Status.RUNNING,
                jnp.int32(Status.INSUFFICIENT_ITER),
                final.status,
            )
            return final.x, make_info(final.it, final.res, status)

        return lax.cond(res1 <= tol2, first_converged, iterate, None)

    def checked(_):
        return lax.cond(bad_diag, failed_zero_diag, run, None)

    return lax.cond(max_iter == 0, insufficient, checked, None)
