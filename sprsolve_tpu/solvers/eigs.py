"""Shift-invert eigensolver driver: interior eigenpairs of a Hermitian
operator near a target σ.

Beyond the reference (which has no eigensolver surface at all) and beyond
plain LOBPCG (which reaches only the spectrum's ends): eigenvalues of
(A − σI)⁻¹ are μ = 1/(λ − σ), so the λ *nearest σ* become the *extreme* μ —
reachable by LOBPCG — at the price of an inner linear solve per operator
application.  The composition:

- the shifted operator is :class:`~sprsolve_tpu.ops.operator.ShiftedOperator`
  (the σ-axpy fused into the SpMV output pass, reordered layouts
  preserved),
- each inverse application is a MINRES inner solve (the right Krylov method
  for the symmetric *indefinite* A − σI) running as a ``lax.while_loop``
  *inside* the jitted LOBPCG iteration, vmapped over the (n, 3k) block —
  one compiled program, no host round-trips per apply,
- λ just above σ have μ > 0 (the top of the μ-spectrum) and λ just below σ
  have μ < 0 (the bottom), so both sides are collected with two LOBPCG
  passes and merged host-side by Rayleigh quotients on the ORIGINAL A —
  the reported eigenvalues never pass through the 1/(λ−σ) transform's
  conditioning.

Parity bar: ``scipy.sparse.linalg.eigsh(A, k, sigma=σ)`` (ARPACK
shift-invert with a *direct* inner factorization); here the inner solve is
iterative, which is the standard trade at scales where factorizations are
off the table.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import IncompatibleMatrixFormat, SolveInfo, Status
from ..ops.operator import ShiftedOperator
from .lobpcg import lobpcg
from .minres import minres


@dataclasses.dataclass(frozen=True)
class InvertedOperator:
    """y ≈ A⁻¹·x by an inner MINRES solve — a LinearOperator whose ``matvec``
    is itself a Krylov loop (jit- and vmap-composable: under ``vmap`` the
    ``lax.while_loop`` runs batched until every column converges).

    ``inner_tol``/``inner_max_iter`` are static (they shape the compiled
    loop); ``A`` and ``M`` are pytree data.  ``axis_name`` (static) makes the
    inner solve row-partitioned: set inside ``shard_map`` so every inner
    reduction rides the mesh collective (used by
    :func:`~sprsolve_tpu.parallel.distributed_shift_invert_eigs`).
    """

    A: object
    M: object = None
    inner_tol: float = 1e-8
    inner_max_iter: int = 400
    axis_name: Optional[str] = None
    method: str = "minres"

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return getattr(self.A, "dtype", None)

    def matvec(self, x: jax.Array) -> jax.Array:
        if self.method == "minres":
            solver = minres          # M must be symmetric positive
        elif self.method == "fgmres":
            # flexible inner: M may be ANY operator (multigrid on the
            # indefinite shifted system, an inner Krylov sweep, ...) —
            # MINRES's SPD-M restriction is the reason no available
            # preconditioner helps it on A − σI
            from .fgmres import fgmres

            solver = fgmres
        else:
            raise IncompatibleMatrixFormat(
                f"InvertedOperator: unknown inner method {self.method!r} "
                "(choose 'minres' or 'fgmres')"
            )
        y, _ = solver(
            self.A, x, M=self.M,
            tol=self.inner_tol, max_iter=self.inner_max_iter,
            axis_name=self.axis_name,
        )
        return y

    def matmat(self, X: jax.Array) -> jax.Array:
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)


jax.tree_util.register_dataclass(
    InvertedOperator,
    data_fields=("A", "M"),
    meta_fields=("inner_tol", "inner_max_iter", "axis_name", "method"),
)


def _rayleigh_and_residuals(A, X):
    """Rayleigh quotients and relative residuals on the original A."""
    AX = (
        A.matmat(X)
        if hasattr(A, "matmat")
        else jax.vmap(A.matvec, in_axes=1, out_axes=1)(X)
    )
    lam = jnp.real(jnp.sum(jnp.conj(X) * AX, axis=0))
    R = AX - X * lam[None, :].astype(X.dtype)
    rel = jnp.linalg.norm(R, axis=0) / jnp.maximum(
        jnp.abs(lam), jnp.finfo(lam.dtype).tiny
    )
    return np.asarray(lam), np.asarray(rel)


def shift_invert_eigs(
    A,
    k: int,
    sigma: float,
    *,
    side: str = "both",
    X0: Optional[jax.Array] = None,
    M_inner=None,
    inner_tol: Optional[float] = None,
    inner_max_iter: int = 400,
    inner_method: str = "minres",
    tol: float = 1e-6,
    max_iter: int = 100,
    optimize_layout: bool = True,
    seed: int = 0,
):
    """The ``k`` eigenpairs of Hermitian ``A`` nearest ``sigma``.

    Returns ``(lam, X, info)``: eigenvalues ordered by |λ − σ| ascending,
    their vectors as columns, and a :class:`SolveInfo` whose ``residual``
    is the worst relative residual ‖A·xᵢ − λᵢxᵢ‖/|λᵢ| of the returned pairs
    (computed on the original A, not the inverted operator) and whose
    ``iterations`` counts LOBPCG iterations summed over the passes.

    ``side``: ``"both"`` (default — k nearest from either side of σ, found
    with two LOBPCG passes over the μ-spectrum's two ends), ``"above"`` /
    ``"below"`` (one pass, λ > σ resp. λ < σ only).

    ``M_inner`` preconditions the inner solves.  With the default
    ``inner_method="minres"`` it must be symmetric positive (MINRES's
    requirement) — for the *indefinite* A − σI the safe default is none;
    ``inner_method="fgmres"`` lifts that restriction (any operator,
    including multigrid built on the shifted system or an inner Krylov
    sweep).  For deep-interior σ where no such preconditioner exists,
    :func:`~sprsolve_tpu.solvers.rational.rational_filter_eigs` replaces
    the indefinite inner solves with well-conditioned complex-shifted ones
    (the production interior path).  ``inner_tol`` defaults to
    ``min(tol·1e-2, 1e-8)``:
    the inverse only needs to be applied accurately enough for the
    Rayleigh–Ritz space, and the final residuals are measured on A itself.
    """
    if k < 1:
        raise IncompatibleMatrixFormat(f"need k >= 1, got {k}")
    if side not in ("both", "above", "below"):
        raise IncompatibleMatrixFormat(
            f"side must be 'both', 'above' or 'below', got {side!r}"
        )
    if inner_tol is None:
        inner_tol = min(tol * 1e-2, 1e-8)

    from ..sparse.containers import CSC, CSR

    op = A
    if isinstance(op, CSC):
        op = op.to_csr()
    if optimize_layout and isinstance(op, CSR):
        from ..ops.optimize import optimize as _optimize

        op = _optimize(op)
    if hasattr(op, "pad_vec"):
        # LOBPCG's (n, 3k) block algebra is flat; round-trip reordered
        # layouts per apply (permutations — cheap against the inner solves)
        from ..multigrid import FlatViewOperator

        op = FlatViewOperator(op=op)
    n = op.shape[0]
    dt = getattr(op, "dtype", None)
    if dt is None:
        inner = getattr(op, "op", op)
        if hasattr(inner, "diagonal"):
            dt = jnp.asarray(inner.diagonal()).dtype
        elif X0 is not None:
            dt = jnp.asarray(X0).dtype
        else:
            dt = jnp.float64
    shifted = ShiftedOperator(A=op, shift=jnp.asarray(sigma, dt))
    inv = InvertedOperator(
        A=shifted, M=M_inner,
        inner_tol=float(inner_tol), inner_max_iter=int(inner_max_iter),
        method=str(inner_method),
    )

    # per-pass block size: with side="both", each pass still hunts k pairs
    # (either side of σ may hold all k nearest)
    if X0 is None:
        rng = np.random.default_rng(seed)
        X0 = jnp.asarray(rng.standard_normal((n, k)), dt)
    else:
        X0 = jnp.asarray(X0)
        if X0.shape != (n, k):
            raise IncompatibleMatrixFormat(
                f"X0 must be ({n}, {k}), got {tuple(X0.shape)}"
            )

    passes = {"both": (True, False), "above": (True,), "below": (False,)}[side]
    # μ-space LOBPCG runs a decade tighter than the user's tol: the
    # 1/(λ−σ) transform dilates residuals by an O(1-10) factor near σ, and
    # the CONVERGED gate below is the MEASURED A-residual ≤ tol (strict —
    # no proxy, no fudge factor), so the inner pass must overshoot a bit.
    # LOBPCG converges superlinearly at the end; the margin costs ~1-2
    # iterations.
    run = jax.jit(
        partial(lobpcg, tol=tol / 10, max_iter=max_iter),
        static_argnames="largest",
    )

    cand_vecs, total_its = [], 0
    for largest in passes:
        _, Xp, info_p = run(inv, X0, largest=largest)
        total_its += int(info_p.iterations)
        cand_vecs.append(np.asarray(Xp))

    # merge host-side: Rayleigh quotients on the ORIGINAL operator, dedupe
    # (a pair straddling both passes appears twice), pick k nearest σ
    Xall = jnp.asarray(np.concatenate(cand_vecs, axis=1))
    lam_all, rel_all = _rayleigh_and_residuals(op, Xall)
    return _select_nearest(
        lam_all, rel_all, np.asarray(Xall), sigma, side, k, tol, total_its
    )


def _select_nearest(lam_all, rel_all, Xnp, sigma, side, k, tol, total_its):
    """Merge candidate pairs: side filter, |λ−σ| order, dedupe, pick k.

    CONVERGED is gated on the DIRECTLY MEASURED residuals of the returned
    pairs on the original A — not on the inner LOBPCG passes' μ-space
    status: the μ-iteration routinely hits its budget while the Rayleigh
    quotients on A are already within tol, and
    conversely a converged μ-pass with sloppy inner solves could still
    return bad pairs. The measurement is the contract.
    """
    if side == "above":
        keep0 = lam_all >= sigma
    elif side == "below":
        keep0 = lam_all < sigma
    else:
        keep0 = np.ones_like(lam_all, bool)
    order = np.argsort(np.abs(lam_all - sigma))
    sel, lam_sel, rel_sel = [], [], []
    for i in order:
        if not keep0[i]:
            continue
        dup = any(
            abs(np.vdot(Xnp[:, i], Xnp[:, j])) > 0.9 for j in sel
        )
        if dup:
            continue
        sel.append(i)
        lam_sel.append(lam_all[i])
        rel_sel.append(rel_all[i])
        if len(sel) == k:
            break
    lam = jnp.asarray(np.array(lam_sel))
    X = jnp.asarray(Xnp[:, sel])
    worst = float(np.max(rel_sel)) if rel_sel else float("inf")
    status = (
        Status.CONVERGED
        if (len(sel) == k and worst <= tol)
        else Status.INSUFFICIENT_ITER
    )
    info = SolveInfo(
        iterations=jnp.int32(total_its),
        residual=jnp.asarray(worst),
        status=jnp.int32(status),
    )
    return lam, X, info
