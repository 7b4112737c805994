"""``scipy.sparse.linalg``-style entry points.

Drop-in call conventions for users migrating scipy code: ``cg`` /
``bicgstab`` / ``minres`` accept scipy.sparse matrices, dense arrays, this
package's containers/operators, or host ``LinearOperator``-likes, and return
``(x, info)`` with scipy's integer info codes (0 = converged, > 0 = no
convergence within ``maxiter`` [the iteration count], < 0 = breakdown /
invalid input).  Tolerance semantics follow scipy ≥ 1.12:
``‖r‖ ≤ max(rtol·‖b‖, atol)``.

Under the hood everything routes through :func:`sprsolve_tpu.solve`, so a
scipy-shaped call still gets the layout optimizer (DIA / BSR / RCM)
and runs the same execution paths as the native API.  This is an
interop veneer — new code should prefer :func:`sprsolve_tpu.solve` or the
functional solvers, which return the richer :class:`SolveInfo`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .api import solve as _solve
from .errors import BreakDown, InvalidPreconditioner, Status, ZeroDiagonalElem
from .ops.operator import as_operator
from .sparse.containers import CSR, csr_from_scipy

__all__ = [
    "aslinearoperator", "bicgstab", "cg", "cgs", "eigsh", "gmres", "lobpcg",
    "lsqr", "minres", "tfqmr",
]


def _is_scipy_sparse(a) -> bool:
    # LinearOperator also lives under scipy.sparse.*; a sparse *matrix* is
    # what tocsr() identifies
    return type(a).__module__.startswith("scipy.sparse") and hasattr(a, "tocsr")


class _CallbackOperator:
    """Wraps a host-side ``matvec`` (e.g. a scipy ``LinearOperator``) so it
    can participate in jitted solves via ``jax.pure_callback``.  Every apply
    round-trips device → host → device: correct, composable, slow — for
    interop and testing, not production."""

    def __init__(self, a):
        self._a = a
        self.shape = tuple(a.shape)

    def matvec(self, x: jax.Array) -> jax.Array:
        spec = jax.ShapeDtypeStruct(x.shape, x.dtype)
        return jax.pure_callback(
            lambda v: np.asarray(self._a.matvec(np.asarray(v)), dtype=v.dtype),
            spec,
            x,
            vmap_method="sequential",
        )

    def matvec_dot(self, x: jax.Array):
        from .vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)


# static pytree node (identity-hashed): the host object crosses the jit
# boundary as compile-time constant, its applies run via pure_callback
jax.tree_util.register_static(_CallbackOperator)


def aslinearoperator(a):
    """Coerce ``a`` to this package's operator protocol.

    Accepts: our containers/operators (returned as-is), scipy.sparse
    matrices (converted to a device CSR container), dense arrays, and any
    object exposing ``shape`` + ``matvec`` (wrapped as a host-callback
    operator — the escape hatch for scipy ``LinearOperator``s).
    """
    if _is_scipy_sparse(a):
        return csr_from_scipy(a)
    if isinstance(a, (np.ndarray, jax.Array)) or not hasattr(a, "matvec"):
        return as_operator(a)
    if isinstance(a, CSR) or hasattr(a, "dtype") and isinstance(
        getattr(a, "data", None), jax.Array
    ):
        return a
    # our pytree operators hold jax arrays; host LinearOperators don't
    leaves = jax.tree_util.tree_leaves(a)
    if leaves and all(isinstance(l, jax.Array) for l in leaves):
        return a
    return _CallbackOperator(a)


def _run(method: str, A, b, x0, rtol, atol, maxiter, M, **solver_kwargs):
    b_np = np.asarray(b)
    n = b_np.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    bnorm = float(np.linalg.norm(b_np))
    tol = rtol if bnorm == 0.0 else max(float(rtol), float(atol) / bnorm)

    op = A if isinstance(A, CSR) else aslinearoperator(A)
    if M is not None and not isinstance(M, str):
        M = aslinearoperator(M)
    try:
        x, info = _solve(
            op, b, method=method, M=M, tol=tol, max_iter=maxiter, x0=x0,
            **solver_kwargs,
        )
    except (BreakDown, InvalidPreconditioner, ZeroDiagonalElem):
        return jnp.zeros_like(jnp.asarray(b)), -1
    status = int(info.status)
    if status == Status.CONVERGED:
        return x, 0
    if status == Status.INSUFFICIENT_ITER:
        return x, int(info.iterations)  # scipy: info > 0 = stopped at maxiter
    return x, -abs(status)


def cg(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
       maxiter: Optional[int] = None, M=None):
    """SPD conjugate-gradient solve, ``scipy.sparse.linalg.cg`` conventions."""
    return _run("cg", A, b, x0, rtol, atol, maxiter, M)


def bicgstab(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None):
    """``scipy.sparse.linalg.bicgstab`` conventions."""
    return _run("bicgstab", A, b, x0, rtol, atol, maxiter, M)


def cgs(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
        maxiter: Optional[int] = None, M=None):
    """``scipy.sparse.linalg.cgs`` conventions."""
    return _run("cgs", A, b, x0, rtol, atol, maxiter, M)


def tfqmr(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
          maxiter: Optional[int] = None, M=None, show: bool = False):
    """``scipy.sparse.linalg.tfqmr`` conventions (``show`` is accepted and
    ignored — no per-iteration printing from inside a jitted loop)."""
    return _run("tfqmr", A, b, x0, rtol, atol, maxiter, M)


def gmres(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
          restart: Optional[int] = None, maxiter: Optional[int] = None, M=None):
    """``scipy.sparse.linalg.gmres`` conventions.

    As in scipy, ``maxiter`` counts restart *cycles* (inner steps are
    ``maxiter·restart``) and ``restart`` defaults to ``min(20, n)``.
    """
    n = np.asarray(b).shape[0]
    if restart is None:
        restart = min(20, n)
    if maxiter is None:
        maxiter = min(10 * n, 1000)
    return _run(
        "gmres", A, b, x0, rtol, atol, maxiter * restart, M, restart=restart
    )


def minres(A, b, x0=None, *, shift: float = 0.0, rtol: float = 1e-5,
           maxiter: Optional[int] = None, M=None):
    """``scipy.sparse.linalg.minres`` conventions.

    ``shift`` solves (A − shift·I)·x = b via
    :class:`~sprsolve_tpu.ops.operator.ShiftedOperator` (the operator wrapper
    keeps the SpMV layout; XLA fuses the shift axpy into the SpMV pass).
    """
    if shift != 0.0:
        from .ops.operator import ShiftedOperator
        from .ops.optimize import optimize as _optimize

        op = aslinearoperator(A)
        if isinstance(op, CSR):
            # pick the execution layout *before* wrapping — solve() only
            # optimizes raw containers, and the shift must ride the kernel
            op = _optimize(op)
        A = ShiftedOperator(A=op, shift=jnp.asarray(shift, _op_dtype(op, b)))
    return _run("minres", A, b, x0, rtol, 0.0, maxiter, M)


def _op_dtype(op, b):
    dt = getattr(op, "dtype", None)
    return dt if dt is not None else jnp.asarray(b).dtype


def lobpcg(A, X, B=None, M=None, Y=None, tol=None, maxiter: int = 20,
           largest: bool = True, verbosityLevel: int = 0):
    """``scipy.sparse.linalg.lobpcg`` conventions (standard problem only).

    Returns ``(w, v)``.  ``B`` (generalized problem) and ``Y`` (constraints)
    are unsupported; ``largest`` defaults to True as in scipy.
    """
    if B is not None or Y is not None:
        raise NotImplementedError("lobpcg B/Y are not supported")
    from .solvers import lobpcg as _lobpcg

    X = jnp.asarray(X)
    if not jnp.issubdtype(X.dtype, jnp.inexact):
        # scipy accepts integer X after promotion; np.finfo would raise
        X = X.astype(jnp.promote_types(X.dtype, jnp.float32))
    if tol is None:
        tol = float(np.sqrt(np.finfo(np.asarray(X).dtype).eps))
    op = aslinearoperator(A)
    if M is not None:
        M = aslinearoperator(M)
    w, v, _info = _lobpcg(
        op, X, M=M, largest=largest, tol=tol, max_iter=maxiter
    )
    if largest:  # scipy returns descending for largest
        return w[::-1], v[:, ::-1]
    return w, v


def eigsh(A, k: int = 6, M=None, sigma=None, which: str = "LM", v0=None,
          ncv=None, maxiter=None, tol: float = 0,
          return_eigenvectors: bool = True, mode: str = "normal",
          precond=None):
    """``scipy.sparse.linalg.eigsh`` conventions (supported subset).

    Returns ``(w, v)`` (ascending ``w``) or ``w`` alone when
    ``return_eigenvectors=False``.

    Supported-subset notes:

    - ``sigma=None``: ``which`` must be ``"LA"`` (largest algebraic) or
      ``"SA"`` (smallest) — solved by LOBPCG.  ``"LM"`` without a shift
      (largest magnitude) has no LOBPCG analog for indefinite spectra and
      raises.
    - ``sigma`` given: ``which="LM"`` only (ARPACK's shift-invert default —
      the k eigenvalues nearest σ), solved by
      :func:`~sprsolve_tpu.solvers.shift_invert_eigs` with *iterative*
      inner solves (MINRES) instead of ARPACK's direct factorization.
    - ``M`` (generalized problem), ``ncv``, and ``mode != "normal"`` are
      unsupported and raise.
    - ``tol=0`` maps to scipy's machine-precision intent as ``√ε`` of the
      working dtype (exact 0 is unreachable for an iterative method).
    - ``v0`` seeds the first column of the search block.
    - ``precond`` (extension beyond scipy, LOBPCG path only): ``"jacobi"``,
      a prebuilt ≈A⁻¹ operator, or ``None``.  At scale this is the
      difference between converging and not — the smallest grid-operator
      eigenvalues cluster at O(h²) and unpreconditioned LOBPCG is
      gap-limited (a multigrid M restores convergence where
      unpreconditioned LOBPCG stalls).
    """
    if M is not None or ncv is not None or mode != "normal":
        raise NotImplementedError("eigsh M/ncv/mode are not supported")
    if precond is not None and sigma is not None:
        raise NotImplementedError(
            "precond applies to the LOBPCG path (sigma=None); the "
            "shift-invert inner MINRES on the indefinite A - sigma*I "
            "has no safe SPD preconditioner to build automatically"
        )
    if isinstance(precond, str):
        if precond != "jacobi":
            raise NotImplementedError(
                f"precond={precond!r}: 'jacobi', a prebuilt operator, or "
                "None (for multigrid build GridMGPrecond.from_csr and pass "
                "it; the CLI's 'eig --precond mg --grid ...' does exactly "
                "that)"
            )
        d = np.asarray(A.diagonal_host()) if hasattr(A, "diagonal_host") \
            else np.asarray(A.diagonal())
        d = np.where(d == 0, 1.0, np.abs(d))
        from .precond import DiagPrecond

        precond = DiagPrecond.new(d)
    op = aslinearoperator(A)
    n = op.shape[0]
    dt = _op_dtype(op, np.zeros(0))
    if tol == 0:
        tol = float(np.sqrt(np.finfo(np.dtype(dt)).eps))
    rng = np.random.default_rng(0)
    X0 = np.asarray(rng.standard_normal((n, k)), np.dtype(dt))
    if v0 is not None:
        X0[:, 0] = np.asarray(v0, X0.dtype).ravel()
    if sigma is None:
        if which not in ("LA", "SA"):
            raise NotImplementedError(
                "eigsh without sigma supports which='LA'/'SA' only "
                f"(got {which!r}); for eigenvalues nearest a target pass "
                "sigma="
            )
        from .solvers import lobpcg as _lobpcg

        w, v, _info = _lobpcg(
            op, jnp.asarray(X0), M=precond, largest=(which == "LA"),
            tol=tol,
            max_iter=200 if maxiter is None else maxiter,
            # guard buffer (ARPACK's ncv > k analog): protects the k-th
            # pair's convergence when it sits in a cluster
            buffer=min(k, 4),
        )
    else:
        if which != "LM":
            raise NotImplementedError(
                "eigsh with sigma supports which='LM' (nearest sigma) only"
            )
        from .solvers import shift_invert_eigs as _sie

        w, v, _info = _sie(
            op, k, float(sigma), X0=jnp.asarray(X0), tol=tol,
            max_iter=100 if maxiter is None else maxiter,
            optimize_layout=False,
        )
        order = jnp.argsort(w)
        w, v = w[order], v[:, order]
        # scipy's eigsh returns exactly k pairs or raises
        # ArpackNoConvergence; shift_invert_eigs's dedupe/side filter can
        # select fewer when < k distinct pairs converged near sigma —
        # mirror scipy's contract instead of silently returning a short
        # array (ADVICE r3)
        if w.shape[0] < k:
            from scipy.sparse.linalg import ArpackNoConvergence

            raise ArpackNoConvergence(
                f"eigsh(sigma={sigma}): only {w.shape[0]} of {k} requested "
                "eigenpairs converged (try a larger maxiter, looser tol, or "
                "a different sigma)",
                np.asarray(w), np.asarray(v),
            )
    if return_eigenvectors:
        return np.asarray(w), np.asarray(v)
    return np.asarray(w)


def lsqr(A, b, damp: float = 0.0, atol: float = 1e-6, btol: float = 1e-6,
         conlim: float = 1e8, iter_lim: Optional[int] = None,
         show: bool = False, calc_var: bool = False, x0=None):
    """``scipy.sparse.linalg.lsqr`` conventions.

    Returns the scipy 10-tuple ``(x, istop, itn, r1norm, r2norm, anorm,
    acond, arnorm, xnorm, var)``.  ``acond`` is not estimated (NaN) and
    ``calc_var`` is unsupported; the solve itself uses ``max(atol, btol)``
    as the unified tolerance of :func:`sprsolve_tpu.solvers.lsqr`.

    Supported-subset notes (deviations from scipy):

    - ``conlim`` is accepted for signature compatibility but **ignored** —
      no condition-number estimate is maintained, so the istop=3/6 exits
      never fire.
    - ``istop=1`` uses the approximation ``r1norm ≤ max(atol, btol)·‖b‖``
      instead of scipy's ``btol·‖b‖ + atol·‖A‖·‖x‖`` test; callers that
      branch on the exact scipy istop semantics should re-derive their
      stopping classification from the returned norms.
    """
    if calc_var:
        raise NotImplementedError("lsqr calc_var is not supported")
    if _is_scipy_sparse(A):
        A = csr_from_scipy(A)
    elif isinstance(A, (np.ndarray, jax.Array)):
        from .sparse.containers import csr_from_dense

        A = csr_from_dense(np.asarray(A))
    if not isinstance(A, CSR):
        raise NotImplementedError(
            "scipy_compat.lsqr needs a matrix input (CSR/scipy.sparse/"
            "dense); for operator inputs call sprsolve_tpu.lsqr with an "
            "explicit AH="
        )
    b_np = np.asarray(b)
    m, n = A.shape
    if iter_lim is None:
        iter_lim = 2 * n
    tol = max(float(atol), float(btol))
    from .api import solve as _api_solve

    x, info = _api_solve(
        A, b, method="lsqr", tol=tol, max_iter=iter_lim, x0=x0, damp=damp
    )
    x_np = np.asarray(x)
    itn = int(info.iterations)
    r = b_np - np.asarray(A.matvec(jnp.asarray(x)))
    r1norm = float(np.linalg.norm(r))
    xnorm = float(np.linalg.norm(x_np))
    r2norm = float(np.sqrt(r1norm**2 + (damp * xnorm) ** 2))
    anorm = float(np.linalg.norm(np.asarray(A.data)))  # Frobenius
    arnorm = float(
        np.linalg.norm(np.asarray(A.adjoint().matvec(jnp.asarray(r)))
                       - (damp * damp) * x_np)
    )
    bnorm = float(np.linalg.norm(b_np))
    if bnorm == 0.0:
        istop = 0
    elif r1norm <= tol * bnorm * 1.01:
        istop = 1
    elif int(info.status) == Status.CONVERGED:
        istop = 2  # least-squares convergence (‖Aᴴr‖ small)
    else:
        istop = 7  # iteration limit
    return (x, istop, itn, r1norm, r2norm, anorm, float("nan"), arnorm,
            xnorm, None)
