"""Object-style API mirroring the reference's public surface (``src/lib.rs:15-21``).

A user of the reference writes::

    let mut solver = sprsolve::BiCGStab::new(&lap, n);
    let (iters, res) = solver.solve(rhs, x, 1500, 1e-17).unwrap();

The equivalent here::

    solver = sprsolve_tpu.BiCGStab.new(A, n)
    x, (iters, res) = solver.solve(b, x0, 1500, 1e-17)

``solve``/``precond_solve`` jit-compile the underlying functional solver once
per (operator structure, shape, dtype) and raise the matching
:class:`~sprsolve_tpu.errors.SolverError` subclass on failure — the analog of
``.unwrap()``.  The functional API (``sprsolve_tpu.solvers``) is the
jit-composable form; this layer is the drop-in convenience form.

There is no explicit preallocated workspace (``src/bicg_stab.rs:25-31``): the
while_loop carry *is* the workspace and XLA buffer donation reuses it across
iterations.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .errors import IncompatibleMatrixFormat
from .ops.operator import as_operator
from .solvers import (
    bicgstab,
    bicgstabl,
    ca_bicgstab,
    ca_cg,
    cg,
    cg_single_sync,
    cgs,
    cocg,
    cs_minres,
    fgmres,
    gauss_seidel,
    gmres,
    idrs,
    lsqr,
    minres,
    tfqmr,
)
from .sparse.containers import CSR, ELL


def _run(fn, A, b, x, max_iter, tol, M=None):
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x is None else jnp.asarray(x)
    kwargs = dict(tol=tol, max_iter=max_iter)
    if M is not None:
        kwargs["M"] = M
    xr, info = jax.jit(partial(fn, **kwargs))(A, b, x)
    info.raise_if_error()
    return xr, (int(info.iterations), float(info.residual))


def _auto_method(A, parity: str = "fast") -> str:
    """Pick a solver from the matrix structure (host-side, O(nnz)):
    Hermitian — incl. real symmetric — → ``minres`` (safe for indefinite
    systems, unlike CG); complex symmetric (Aᵀ = A, non-Hermitian) →
    ``cocg``; anything else (or a non-container operator, which cannot be
    inspected) → ``bicgstabl`` with ℓ=2, the robust nonsymmetric path
    (robustness: the 20-seed sweep in tests/test_bicgstabl.py; its speed
    against plain BiCGStab on the GPU is not measured yet).
    ``parity="reference"`` keeps plain ``bicgstab`` — the reference's own
    nonsymmetric iteration (``src/bicg_stab.rs``) — for users who need
    iteration-count parity with it."""
    import numpy as np

    from .sparse.containers import CSC, CSR

    nonsym = "bicgstab" if parity == "reference" else "bicgstabl"
    if isinstance(A, CSC):
        A = A.to_csr()
    if not isinstance(A, CSR):
        return nonsym
    import scipy.sparse as sps

    S = sps.csr_matrix(
        (np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
        shape=A.shape,
    )
    if S.shape[0] != S.shape[1]:
        return "lsqr"
    scale = float(abs(S).max()) if S.nnz else 0.0
    if scale == 0.0:
        return nonsym
    tol = 1e-12 * scale

    def _dev(X):
        return float(abs(X).max()) if X.nnz else 0.0

    if _dev(S - S.getH()) <= tol:
        return "minres"
    if np.iscomplexobj(np.asarray(A.data)) and _dev(S - S.T) <= tol:
        return "cocg"
    return nonsym


_SOLVERS = {
    "bicgstab": bicgstab,
    "bicgstabl": bicgstabl,
    "ca_bicgstab": ca_bicgstab,
    "ca_cg": ca_cg,
    "cg": cg,
    "cg_single_sync": cg_single_sync,
    "cgs": cgs,
    "cocg": cocg,
    "minres": minres,
    "tfqmr": tfqmr,
    "cs_minres": cs_minres,
    "fgmres": fgmres,
    "gmres": gmres,
    "idrs": idrs,
    "lsqr": lsqr,
}

# the s-step pair runs a dedicated pipeline in solve(): flat-vector layouts
# only (no pad_vec layouts — the basis block stacks [p, r]), Gershgorin
# bounds defaulted for the Chebyshev basis, and Jacobi preconditioning by
# operator folding (ca_cg) instead of an M apply
_CA_METHODS = ("ca_cg", "ca_bicgstab")


def _solve_ca(A, b, *, method, M, tol, max_iter, x0, optimize_layout,
              **solver_kwargs):
    """:func:`solve`'s s-step pipeline (ca_cg / ca_bicgstab).

    The CA solvers take no ``M`` argument — their basis is a polynomial in
    the bare operator.  ``ca_cg`` accepts ``M='jacobi'`` (or a real
    :class:`~sprsolve_tpu.precond.DiagPrecond`) by *folding* it into the
    system via symmetric diagonal scaling
    (:func:`~sprsolve_tpu.solvers.ca_cg.fold_jacobi`) — mathematically
    Jacobi-CG, structurally still one all-reduce per s-block.  Execution
    layout: DIA when the pattern is banded (the XLA shifted-slice path),
    else the CSR gather path; never a reordered layout.
    """
    from .errors import InvalidPreconditioner
    from .sparse.containers import CSC, DIA
    from .solvers.ca_cg import fold_jacobi
    from .utils.bounds import gershgorin_bounds

    src = A.to_csr() if isinstance(A, CSC) else A

    unfold = None
    if M is not None:
        foldable = isinstance(M, str) and M == "jacobi"
        if method != "ca_cg" or not foldable or not isinstance(src, CSR):
            raise InvalidPreconditioner(
                "the s-step solvers take no M apply (the CA basis is a "
                "polynomial in the bare operator); ca_cg supports "
                "M='jacobi' on a CSR/CSC input by folding it into the "
                "system — for anything stronger use cg/cg_single_sync/"
                "bicgstab with M"
            )
        src, b, x0, unfold = fold_jacobi(src, b, x0)

    op = src
    if isinstance(src, CSR) and optimize_layout:
        try:
            op = src.to_dia()
        except ValueError:
            op = src  # wide/unstructured pattern: CSR gather path

    if solver_kwargs.get("bounds") is None and isinstance(op, (CSR, DIA)):
        solver_kwargs["bounds"] = gershgorin_bounds(op)

    solver = _SOLVERS[method]
    x_run, info = jax.jit(
        partial(solver, tol=tol, max_iter=max_iter, **solver_kwargs)
    )(op, jnp.asarray(b), x0 if x0 is None else jnp.asarray(x0))
    if unfold is not None:
        x_run = unfold(x_run)
    return x_run, info


def _prepare_op_M(A, method: str, M, optimize_layout: bool):
    """Shared pipeline of :func:`solve` and :func:`prepare`: pick the
    execution layout for ``A`` and build/re-lay the preconditioner.

    Returns ``(op, M, padded)`` where ``padded`` means the operator works in
    its own internal vector layout (``Reordered`` exposes
    ``pad_vec``/``unpad_vec``) and vectors must be converted at the solve
    boundary.
    """
    from .errors import InvalidPreconditioner
    from .ops.optimize import optimize as _optimize
    from .precond import DiagPrecond as _DP
    from .precond import IC0Precond, ILU0Precond, RelayedPrecond
    from .sparse.containers import CSC

    if method == "lsqr":
        # rectangular-capable: stay on the CSR execution path (the layout
        # optimizer's formats are square-system layouts, and A/Aᴴ must live
        # in compatible layouts)
        if M is not None:
            raise InvalidPreconditioner(
                "lsqr has no preconditioned form; pass M=None"
            )
        return (A.to_csr() if isinstance(A, CSC) else A), None, False

    if isinstance(M, str) and M == "amg":
        if method == "cs_minres":
            raise InvalidPreconditioner(
                "cs_minres's preconditioned form needs a REAL symmetric-"
                "positive M (e.g. M='jacobi' → 1/|d|); an AMG hierarchy "
                "built from a complex-symmetric matrix is not one"
            )
        # algebraic multigrid-lite: RCM localizes the graph so consecutive-
        # pair (1-D grid) aggregation is meaningful, then the geometric
        # hierarchy machinery applies unchanged. Works for any SPD-ish CSR —
        # no grid shape needed (structured grids should pass their shape to
        # GridMGPrecond.from_csr directly for true geometric coarsening).
        from .multigrid import GridMGPrecond
        from .ops.reordered import Reordered
        from .precond import RelayedPrecond
        from .sparse.containers import reorder_rcm

        src = A.to_csr() if isinstance(A, CSC) else A
        if not isinstance(src, CSR):
            raise InvalidPreconditioner(
                "M='amg' builds from the matrix on the host and needs a "
                "CSR/CSC input (got an operator); build GridMGPrecond."
            )
        A_rcm, perm = reorder_rcm(src)
        mg = GridMGPrecond.from_csr(A_rcm, (A_rcm.shape[0],))
        inner_op = _optimize(A_rcm) if optimize_layout else A_rcm
        op = Reordered.wrap(inner_op, perm)
        if hasattr(inner_op, "pad_vec"):
            # MG lives in permuted-flat space; relay through the inner
            # layout only (the outer Reordered boundary handles perm)
            return op, RelayedPrecond(inner=mg, op=inner_op), True
        return op, mg, True


    op = A
    if optimize_layout:
        if isinstance(A, CSC):
            op = _optimize(A.to_csr())
        elif isinstance(A, CSR):
            op = _optimize(A)

    if method == "cs_minres" and isinstance(M, str) and M != "jacobi":
        # gate the string builders BEFORE they run: an ILU0/IC0 sweep apply
        # is nonsymmetric and a block-Jacobi of a complex-symmetric matrix
        # has complex blocks — neither is a valid Saunders preconditioner
        raise InvalidPreconditioner(
            "cs_minres's preconditioned form needs a REAL symmetric-"
            "positive M⁻¹; of the string builders only M='jacobi' "
            "(→ 1/|d|) qualifies"
        )

    if isinstance(M, str) and M in ("ilu0", "ic0", "block_jacobi"):
        src = A.to_csr() if isinstance(A, CSC) else A
        if not isinstance(src, CSR):
            raise InvalidPreconditioner(
                f"M={M!r} builds from the matrix on the host and needs a "
                "CSR/CSC input (got an operator); build the preconditioner "
                "object directly."
            )
        if M == "block_jacobi":
            from .precond import BlockJacobiPrecond

            M = BlockJacobiPrecond.from_csr(src)
        else:
            M = (ILU0Precond if M == "ilu0" else IC0Precond).from_csr(src)

    if method == "cs_minres" and M is not None:
        # cs_minres's preconditioned form (beyond the reference — the
        # Saunders adaptation of src/minres.rs:178-341) requires a REAL
        # symmetric-positive M⁻¹.  M='jacobi' builds the standard real
        # 1/|diag| (Freund) in the operator's own layout; known-invalid
        # classes (complex diagonals, nonsymmetric triangular-sweep
        # applies) are rejected up front rather than left to the
        # probabilistic runtime β² gate.
        from .precond import ComplexDiagPrecond, real_abs_jacobi

        if isinstance(M, str):
            # only 'jacobi' reaches here (other strings rejected above,
            # before their builders could run)
            M = real_abs_jacobi(op if hasattr(op, "matvec") else A)
            # real_abs_jacobi returns M in the operator's own (possibly
            # permuted) layout — skip the generic relay below
            return op, M, hasattr(op, "pad_vec")
        from .precond import BlockJacobiPrecond

        if isinstance(M, ComplexDiagPrecond) or (
            isinstance(M, _DP) and jnp.iscomplexobj(M.diag_inv)
        ) or isinstance(M, (ILU0Precond, IC0Precond)) or (
            isinstance(M, BlockJacobiPrecond)
            and jnp.iscomplexobj(M.inv_blocks)
        ):
            raise InvalidPreconditioner(
                "cs_minres's preconditioned form needs a REAL symmetric-"
                "positive M⁻¹ (a complex diagonal/block Jacobi or a "
                "nonsymmetric ILU0/IC0 sweep apply is not one); use "
                "M='jacobi' or a real SPD operator"
            )

    padded = hasattr(op, "pad_vec")
    if padded:
        if isinstance(M, str) and M == "jacobi":
            M = op.jacobi_precond()
        elif isinstance(M, _DP):
            # re-lay the diagonal into the operator's internal layout
            # (padding and/or permutation); zero pads stay inert
            try:
                M = op.relay_diag_precond(M)
            except NotImplementedError as e:
                raise InvalidPreconditioner(str(e)) from e
        elif M is not None:
            # any other flat-layout preconditioner (ILU0/IC0/Chebyshev/GS):
            # round-trip each apply through the operator's internal layout
            M = RelayedPrecond(inner=M, op=op)
    elif isinstance(M, str) and M == "jacobi":
        diag = op.diagonal() if hasattr(op, "diagonal") else A.diagonal()
        M = _DP.new(diag)
    return op, M, padded


def solve(
    A,
    b,
    *,
    method: str = "bicgstab",
    M=None,
    tol: float = 1e-8,
    max_iter: int = 1000,
    x0=None,
    optimize_layout: bool = True,
    **solver_kwargs,
):
    """One-call solve: pick the execution layout, run, return ``(x, info)``.

    ``A`` may be a CSR container (layout chosen via :func:`optimize` — DIA
    for banded matrices, BSR or a band+outlier split otherwise) or any
    LinearOperator (used as-is).

    ``method``: ``"auto"`` picks from the matrix structure (Hermitian/real
    symmetric → ``minres``, complex symmetric → ``cocg``, else
    ``bicgstabl`` with ℓ=2, the robust nonsymmetric path — an O(nnz)
    host-side check; pass ``parity="reference"`` to get the
    reference's plain ``bicgstab`` iteration instead),
    ``"bicgstab"`` (default), ``"bicgstabl"`` (BiCGStab(ℓ),
    accepts ``l=``; cycles of 2ℓ SpMVs with an ℓ-dimensional MR step — for
    spectra where plain BiCGStab stagnates), ``"cg"``, ``"minres"``,
    ``"cs_minres"``, ``"cocg"`` (complex-symmetric CG; takes the complex
    Jacobi), ``"cgs"`` / ``"tfqmr"`` (transpose-free CGS-family methods:
    CGS converges fast but erratically, TFQMR smooths it at the same
    2-SpMV/iter cost), ``"gmres"`` (accepts ``restart=``), ``"idrs"``
    (accepts ``s=``), ``"lsqr"`` (rectangular; accepts ``damp=``/``AH=``),
    ``"ca_cg"`` / ``"ca_bicgstab"`` (s-step communication-avoiding pair;
    accept ``s=``/``basis=``/``bounds=``, bounds defaulting to Gershgorin —
    mesh-latency optimized, ~2× the SpMV work on a single device).
    See ``docs/solvers.md`` for the selection guide.

    ``M``: a preconditioner object, or one of the strings ``"jacobi"``,
    ``"block_jacobi"``, ``"ilu0"``, ``"ic0"``, ``"amg"`` (built from the
    matrix here).  ``method="ca_cg"`` supports ``M="jacobi"`` only, by
    folding it into the operator (symmetric diagonal scaling — ``tol``
    then applies to the preconditioned-residual norm; see
    :func:`~sprsolve_tpu.solvers.ca_cg.fold_jacobi`); ``ca_bicgstab``
    takes no M.  For ``method="cs_minres"`` only ``"jacobi"`` (which
    builds the real 1/|d| the Saunders process requires) or a real
    symmetric-positive operator is accepted.  See
    ``docs/preconditioners.md``.

    This is the high-level entry a user of the reference's
    ``BiCGStab::new(...).solve(...)`` flow reaches for when they don't care
    about layouts.  For many right-hand sides use :func:`prepare`; for
    f64/c128 accuracy from f32/c64 inner solves use
    :func:`~sprsolve_tpu.solvers.refine_solve`.
    """
    if method == "auto":
        method = _auto_method(A, parity=solver_kwargs.pop("parity", "fast"))
        if method == "bicgstabl":
            solver_kwargs.setdefault("l", 2)
    solver = _SOLVERS[method]
    b = jnp.asarray(b)
    # validate BEFORE the layout conversion — pad_vec would silently accept
    # a short b (reference rejects mismatched dims at
    # the API boundary: ``src/bicg_stab.rs:44-52``)
    n = getattr(A, "shape", (None,))[0]
    if n is not None and b.shape != (n,):
        raise IncompatibleMatrixFormat(
            "Input vec dimension doesn't match the matrix size"
        )
    if x0 is not None and n is not None and jnp.shape(x0) != (n,):
        raise IncompatibleMatrixFormat(
            "x0 dimension doesn't match the matrix size"
        )

    if method in _CA_METHODS:
        return _solve_ca(
            A, b, method=method, M=M, tol=tol, max_iter=max_iter, x0=x0,
            optimize_layout=optimize_layout, **solver_kwargs,
        )

    op, M, padded = _prepare_op_M(A, method, M, optimize_layout)
    if method == "lsqr" and "AH" not in solver_kwargs:
        if not hasattr(op, "adjoint"):
            raise IncompatibleMatrixFormat(
                "lsqr needs the adjoint operator: pass AH= (or use a CSR/CSC "
                "container, whose adjoint is built automatically)"
            )
        solver_kwargs["AH"] = op.adjoint()  # host-side build, before the jit
    if solver_kwargs:
        solver = partial(solver, **solver_kwargs)  # e.g. restart= for gmres
    if padded:
        b_run = op.pad_vec(b)
        x0_run = op.pad_vec(jnp.asarray(x0)) if x0 is not None else None
    else:
        b_run = b
        x0_run = jnp.asarray(x0) if x0 is not None else None

    kwargs = dict(tol=tol, max_iter=max_iter)
    if M is not None:
        kwargs["M"] = M
    x_run, info = jax.jit(partial(solver, **kwargs))(op, b_run, x0_run)
    if padded:
        return op.unpad_vec(x_run), info
    return x_run, info


class PreparedSolver:
    """A solve pipeline optimized once, reusable across right-hand sides.

    The serving-style counterpart of :func:`solve`: layout analysis
    (``optimize()``), preconditioner construction (including host-side ILU/IC
    factorization), and jit compilation all happen once in :func:`prepare`;
    each call converts ``b``/``x0`` at the boundary and runs the cached
    executable.  The analog of the reference's ``mkl_sparse_set_mv_hint`` +
    ``mkl_sparse_optimize`` amortization (``src/mkl_mat.rs:81-148``), extended
    to the whole solve.

    Warm starts chain naturally::

        handle = sp.prepare(A, method="bicgstab", M="jacobi", tol=1e-8)
        x1, info1 = handle(b1)
        x2, info2 = handle(b2, x0=x1)   # previous solution as initial guess
    """

    def __init__(self, op, solver, kwargs, n):
        self._op = op
        self._padded = hasattr(op, "pad_vec")
        self._n = n
        self._run = jax.jit(partial(solver, **kwargs))

    @property
    def operator(self):
        """The optimized execution-layout operator (shared, reusable)."""
        return self._op

    def __call__(self, b, x0=None):
        b = jnp.asarray(b)
        if b.shape != (self._n,):
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
        x0 = None if x0 is None else jnp.asarray(x0)
        if self._padded:
            b_run = self._op.pad_vec(b)
            x0_run = None if x0 is None else self._op.pad_vec(x0)
        else:
            b_run, x0_run = b, x0
        x_run, info = self._run(self._op, b_run, x0_run)
        if self._padded:
            return self._op.unpad_vec(x_run), info
        return x_run, info


def prepare(
    A,
    *,
    method: str = "bicgstab",
    M=None,
    tol: float = 1e-8,
    max_iter: int = 1000,
    optimize_layout: bool = True,
    **solver_kwargs,
) -> PreparedSolver:
    """Build a :class:`PreparedSolver` for repeated solves against ``A``.

    Accepts the same inputs as :func:`solve` (CSR/CSC containers or any
    operator; ``M`` as an object or ``"jacobi"``/``"ilu0"``/``"ic0"``;
    ``method="auto"`` picks from the matrix structure as in :func:`solve`).
    """
    if method == "auto":
        method = _auto_method(A, parity=solver_kwargs.pop("parity", "fast"))
        if method == "bicgstabl":
            solver_kwargs.setdefault("l", 2)
    solver = _SOLVERS[method]
    op, M, _ = _prepare_op_M(A, method, M, optimize_layout)
    if method == "lsqr" and "AH" not in solver_kwargs:
        if not hasattr(op, "adjoint"):
            raise IncompatibleMatrixFormat(
                "lsqr needs the adjoint operator: pass AH= (or use a CSR/CSC "
                "container, whose adjoint is built automatically)"
            )
        solver_kwargs["AH"] = op.adjoint()  # host-side build, before the jit
    kwargs = dict(tol=tol, max_iter=max_iter, **solver_kwargs)
    if M is not None:
        kwargs["M"] = M
    return PreparedSolver(op, solver, kwargs, A.shape[0])


class BiCGStab:
    """BiCGStab solver handle (reference ``src/bicg_stab.rs:25-31``)."""

    def __init__(self, A, size: int):
        self.A = as_operator(A)
        if self.A.shape[1] != size:
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
        self.size = size

    new = classmethod(lambda cls, A, size: cls(A, size))

    def solve(self, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(bicgstab, self.A, rhs, x, max_iter, tol)

    def precond_solve(self, precond, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(bicgstab, self.A, rhs, x, max_iter, tol, M=precond)


class MinRes:
    """MINRES solver handle (reference ``src/minres.rs:21-27``)."""

    def __init__(self, A, size: int):
        self.A = as_operator(A)
        if self.A.shape[1] != size:
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
        self.size = size

    new = classmethod(lambda cls, A, size: cls(A, size))

    def solve(self, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(minres, self.A, rhs, x, max_iter, tol)

    def precond_solve(self, precond, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(minres, self.A, rhs, x, max_iter, tol, M=precond)


class CG:
    """Conjugate-gradient handle for SPD systems (no reference counterpart —
    completeness extension; same handle shape as :class:`BiCGStab`)."""

    def __init__(self, A, size: int):
        self.A = as_operator(A)
        if self.A.shape[1] != size:
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
        self.size = size

    new = classmethod(lambda cls, A, size: cls(A, size))

    def solve(self, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(cg, self.A, rhs, x, max_iter, tol)

    def precond_solve(self, precond, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(cg, self.A, rhs, x, max_iter, tol, M=precond)


class GMRES:
    """Restarted GMRES(m) handle for general systems (no reference
    counterpart — completeness extension; same handle shape as
    :class:`BiCGStab`). ``restart`` is the Krylov dimension per cycle."""

    def __init__(self, A, size: int, restart: int = 32):
        self.A = as_operator(A)
        if self.A.shape[1] != size:
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
        self.size = size
        self.restart = int(restart)

    new = classmethod(lambda cls, A, size, restart=32: cls(A, size, restart))

    def solve(self, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(
            partial(gmres, restart=self.restart), self.A, rhs, x, max_iter, tol
        )

    def precond_solve(self, precond, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(
            partial(gmres, restart=self.restart),
            self.A, rhs, x, max_iter, tol, M=precond,
        )


class CSMinRes:
    """Complex-symmetric MINRES handle (reference ``src/cs_minres.rs:17-25``)."""

    def __init__(self, A, size: int):
        self.A = as_operator(A)
        if self.A.shape[1] != size:
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
        self.size = size

    new = classmethod(lambda cls, A, size: cls(A, size))

    def solve(self, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(cs_minres, self.A, rhs, x, max_iter, tol)

    def precond_solve(self, precond, rhs, x=None, max_iter: int = 1000,
                      tol: float = 1e-12):
        """Preconditioned Saunders process — beyond the reference (its
        CSMinRes exports only ``solve``). ``precond`` must apply a REAL
        symmetric-positive M⁻¹ (see ``solvers/cs_minres.py``)."""
        return _run(cs_minres, self.A, rhs, x, max_iter, tol, M=precond)


class GaussSeidel:
    """Gauss-Seidel handle (reference ``src/gauss_seidel.rs:13-31``).

    Accepts CSR or ELL; CSR is converted to the ELL execution layout once at
    construction. Raises on non-square input like the reference ``new``.
    """

    def __init__(self, A):
        if isinstance(A, CSR):
            A = A.to_ell()
        if not isinstance(A, ELL):
            raise IncompatibleMatrixFormat("Not in CSR format")
        if A.shape[0] != A.shape[1]:
            raise IncompatibleMatrixFormat("Not a square matrix")
        self.A = A

    new = classmethod(lambda cls, A: cls(A))

    def solve(self, rhs, x=None, max_iter: int = 1000, eps: float = 0.0):
        b = jnp.asarray(rhs)
        x = jnp.zeros_like(b) if x is None else jnp.asarray(x)
        xr, info = jax.jit(
            partial(gauss_seidel, max_iter=max_iter, eps=eps)
        )(self.A, b, x)
        info.raise_if_error()
        return xr, (int(info.iterations), float(info.residual))
