"""LOBPCG: preconditioned block eigensolver for extreme eigenpairs.

Not present in the reference (its surface is linear *solvers*,
``src/lib.rs:15-21``); added for framework completeness — LOBPCG is the
standard sparse-eigenvalue companion of a Krylov-solver library (cf.
``scipy.sparse.linalg.lobpcg``), and it maps well onto an accelerator: per
iteration the work is one operator SpMM on an (n, 3k) tall-skinny block, a
QR and a 3k×3k Hermitian eigendecomposition — all dense matmul shapes —
with no sequential scalar recurrences at all.

Design (robust basis variant): the search space S = [X, W, P] (current
iterates, preconditioned residuals, direction history) is re-orthonormalized
with one QR every iteration, then Rayleigh–Ritz reduces A to QᴴAQ.  This
trades the canonical implementation's cached AX/AW/AP blocks (k SpMVs per
iteration instead of our 3k) for unconditional numerical stability inside a
``lax.while_loop`` — no drift, no conditional basis dropping, static shapes
throughout.  P is the standard difference direction X_new − X·(XᴴX_new),
column-normalized, refreshed from a folded PRNG stream when a column
degenerates (converged directions make S rank-deficient otherwise).

Preconditioning: ``M ≈ A⁻¹`` applied to the residual block accelerates
convergence to the *smallest* eigenpairs exactly as in scipy; any of this
package's preconditioners (Chebyshev, block-Jacobi, IC0, masked-GS) works —
they are linear pure maps, so ``jax.vmap`` lifts their vector apply to the
block.

Distributed (``axis_name`` set, inside ``shard_map``): rows of every block
are partitioned over the mesh axis.  All tall-skinny algebra stays local;
the only collectives are psums of k×k / 3k×3k Gram matrices plus the
operator's own halo exchange (``HaloDIA.matmat`` — one exchange for the
whole block).  QR of the row-sharded basis is replaced by shifted CholQR2
(two rounds of G = psum(SᴴS); chol(G + σI); S ← S·L⁻ᴴ — Fukaya et al.'s
shifted CholeskyQR, whose Gram+triangular-solve structure is exactly the
matmul/psum shape), and the small Rayleigh–Ritz eigenproblem is solved
redundantly on every device from the replicated psum'd projection — no
gather of the basis, ever.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import IncompatibleMatrixFormat, Status
from .common import make_info


def _matmat(A, X):
    if hasattr(A, "matmat"):
        return A.matmat(X)
    return jax.vmap(A.matvec, in_axes=1, out_axes=1)(X)


def _col_norms(X, rdt, axis_name=None):
    ss = jnp.sum(jnp.abs(X) ** 2, axis=0)
    if axis_name is not None:
        ss = lax.psum(ss, axis_name)
    return jnp.sqrt(ss).astype(rdt)


def _safe_colnormalize(X, key, rdt, tiny, axis_name=None):
    """Normalize columns; columns with ~zero norm are replaced by fresh
    deterministic pseudo-random directions (keeps S full-rank)."""
    nrm = _col_norms(X, rdt, axis_name)
    if axis_name is not None:
        # decorrelate the replacement directions across shards (same key on
        # every device would make the global vector block-periodic)
        key = jax.random.fold_in(key, lax.axis_index(axis_name))
    bad = nrm <= tiny
    fresh = jax.random.normal(key, X.shape, dtype=rdt).astype(X.dtype)
    fresh = fresh / _col_norms(fresh, rdt, axis_name)[None, :]
    Xn = X / jnp.where(bad, jnp.ones_like(nrm), nrm)[None, :]
    return jnp.where(bad[None, :], fresh, Xn)


class _State(NamedTuple):
    X: jax.Array       # (n, k) current Ritz vectors (orthonormal)
    AX: jax.Array      # (n, k) A·X, carried so A is applied once per iter
    P: jax.Array       # (n, k) direction history (column-normalized)
    lam: jax.Array     # (k,) real Ritz values
    resmax: jax.Array  # max relative residual of the current pairs
    its: jax.Array
    key: jax.Array


def lobpcg(
    A,
    X0: jax.Array,
    *,
    M=None,
    largest: bool = False,
    tol: float = 1e-6,
    max_iter: int = 200,
    buffer: int = 0,
    axis_name: Optional[str] = None,
):
    """Compute the ``k`` smallest (or largest) eigenpairs of Hermitian ``A``.

    ``X0`` is the (n, k) initial block (random is fine; it is orthonormalized
    here).  Returns ``(lam, X, info)``: ascending real eigenvalues ``(k,)``,
    orthonormal eigenvectors ``(n, k)``, and a
    :class:`~sprsolve_tpu.errors.SolveInfo` whose ``residual`` is the worst
    relative residual ‖A·xᵢ − λᵢ·xᵢ‖ / (|λᵢ| + ‖A‖_est).

    Convergence: all ``k`` pairs below ``tol`` (relative).  Jit-composable;
    ``M`` must be a linear preconditioner apply (≈ A⁻¹ — only sensible for
    ``largest=False``).

    ``buffer``: extra guard columns iterated alongside the wanted block.
    The convergence rate of pair *i* is governed by the gap to the first
    eigenvalue OUTSIDE the block, so when λ_k sits in a cluster a few buffer
    vectors push the effective gap past the cluster — the classical
    block-size heuristic (Knyazev §4).  Convergence is tested on (and the
    return holds) the wanted ``k`` pairs only; the buffer is clamped so the
    enlarged block still satisfies 3·(k+buffer) < n.  The per-iteration SpMM
    grows from (n, 3k) to (n, 3(k+buffer)) — the matrix is still read once
    per SpMM, so the extra columns cost only their own vector traffic.

    ``axis_name``: set inside ``shard_map`` to run row-partitioned over a
    mesh axis (use :func:`~sprsolve_tpu.parallel.distributed_lobpcg` for
    the host-side driver).  ``X0`` and all returned vectors are then the
    per-device row blocks; eigenvalues and ``SolveInfo`` come back
    replicated.
    """
    if X0.ndim != 2:
        raise IncompatibleMatrixFormat("X0 must be (n, k)")
    k_want = X0.shape[1]
    if buffer:
        n_ = X0.shape[0]
        buffer = max(0, min(int(buffer), (n_ - 1) // 3 - k_want))
    if buffer:
        import numpy as _np

        extra = _np.random.default_rng(k_want).standard_normal(
            (X0.shape[0], buffer)
        )
        if jnp.iscomplexobj(X0):
            extra = extra + 1j * _np.random.default_rng(
                k_want + 1
            ).standard_normal(extra.shape)
        X0 = jnp.concatenate([X0, jnp.asarray(extra, X0.dtype)], axis=1)
    if axis_name is None and hasattr(A, "pad_vec"):
        # padded kernel operators work in their internal (rows, lanes)
        # layout; the block algebra here is flat (n, k) — round-trip each
        # apply (pad/unpad are reshapes, cheap against the (n, 3k) SpMM)
        from ..multigrid import FlatViewOperator

        A = FlatViewOperator(op=A)
    if axis_name is None and M is not None and hasattr(M, "pad_vec"):
        from ..multigrid import FlatViewOperator

        M = FlatViewOperator(op=M)
    n, k = X0.shape
    if (
        axis_name is None  # under shard_map A.shape is global, X0 local
        and hasattr(A, "shape")
        and A.shape is not None
        and A.shape[1] != n
    ):
        raise IncompatibleMatrixFormat(
            "Input vec dimension doesn't match the matrix size"
        )
    if 3 * k >= n:
        raise IncompatibleMatrixFormat(
            f"LOBPCG needs 3k < n (got k={k}, n={n}); use a dense eigensolver"
        )
    T = X0.dtype
    rdt = jnp.real(X0).dtype if jnp.iscomplexobj(X0) else T
    tiny = jnp.asarray(jnp.finfo(rdt).tiny * 1e4, rdt)
    tol = jnp.asarray(tol, rdt)
    max_iter = jnp.asarray(max_iter, jnp.int32)

    # Correctness at scale: the block algebra below (QR, Gram products,
    # basis recombinations) is (n, 3k)-shaped matmuls that a default-
    # precision f32 matmul may run in TF32 (~3 decimal digits) — at n ~ 1e6
    # that puts ~1e-2 relative error in the Rayleigh-Ritz projections and
    # the residuals stall. Trace everything at HIGHEST; the cost is
    # negligible next to the SpMM.
    with jax.default_matmul_precision("highest"):
        def orthonormalize(S):
            if axis_name is None:
                return jnp.linalg.qr(S)[0]
            # shifted CholQR2: the row-sharded QR.  Each round is one psum'd
            # Gram matrix + a replicated Cholesky + a local triangular solve;
            # two rounds give QR-grade orthogonality for cond(S) up to
            # ~1/sqrt(eps), and the σ-shift keeps the Cholesky finite even
            # when converged directions make S numerically rank-deficient
            # (the random-refresh scheme then restores rank next iteration).
            dim = S.shape[1]
            eye = jnp.eye(dim, dtype=S.dtype)
            for _ in range(2):
                G = lax.psum(S.conj().T @ S, axis_name)
                sigma = (
                    jnp.asarray(100.0, rdt)
                    * jnp.finfo(rdt).eps
                    * jnp.real(jnp.trace(G)).astype(rdt)
                    / dim
                )
                L = jnp.linalg.cholesky(G + sigma.astype(S.dtype) * eye)
                S = jax.scipy.linalg.solve_triangular(
                    L, S.conj().T, lower=True
                ).conj().T
            return S

        def psum_gram(G):
            return G if axis_name is None else lax.psum(G, axis_name)

        def rayleigh_ritz(S):
            """Orthonormalize S, project A, solve the small Hermitian problem.

            Returns (X, λ, A·X); A·X = (A·Q)·Y reuses the projection's SpMM, so
            the whole iteration applies A exactly once (on the (n, 3k) basis)."""
            Q = orthonormalize(S)
            AQ = _matmat(A, Q)
            Tm = psum_gram(Q.conj().T @ AQ)
            Tm = (Tm + Tm.conj().T) * jnp.asarray(0.5, rdt)
            evals, V = jnp.linalg.eigh(Tm)  # ascending
            if largest:
                sel = slice(Tm.shape[0] - k, None)
                lam = evals[sel][::-1]
                Y = V[:, sel][:, ::-1]
            else:
                lam = evals[:k]
                Y = V[:, :k]
            return Q @ Y, lam, AQ @ Y

        key0 = jax.random.key(0)
        X, lam, AX = rayleigh_ritz(X0)
        P0 = _safe_colnormalize(
            jnp.zeros_like(X), jax.random.fold_in(key0, 0), rdt, tiny, axis_name
        )

        def residual_info(X_, lam_, AX_):
            R = AX_ - X_ * lam_[None, :].astype(T)
            scale = jnp.abs(lam_) + jnp.max(jnp.abs(lam_))
            rel = _col_norms(R, rdt, axis_name) / jnp.maximum(scale, tiny)
            # the wanted pairs occupy the first k_want columns in both search
            # directions; buffer columns never gate convergence
            return R, jnp.max(rel[:k_want])

        _, res0 = residual_info(X, lam, AX)
        st = _State(
            X=X, AX=AX, P=P0, lam=lam, resmax=res0, its=jnp.int32(0), key=key0
        )

        def cond_fn(s_):
            return (s_.its < max_iter) & (s_.resmax > tol)

        def body_fn(s_):
            R, _ = residual_info(s_.X, s_.lam, s_.AX)
            W = R if M is None else _matmat(M, R)
            key = jax.random.fold_in(s_.key, s_.its + 1)
            W = _safe_colnormalize(
                W, jax.random.fold_in(key, 17), rdt, tiny, axis_name
            )
            S = jnp.concatenate([s_.X, W, s_.P], axis=1)
            X_new, lam_new, AX_new = rayleigh_ritz(S)
            P_new = X_new - s_.X @ psum_gram(s_.X.conj().T @ X_new)
            P_new = _safe_colnormalize(
                P_new, jax.random.fold_in(key, 29), rdt, tiny, axis_name
            )
            _, resmax = residual_info(X_new, lam_new, AX_new)
            return _State(
                X=X_new, AX=AX_new, P=P_new, lam=lam_new, resmax=resmax,
                its=s_.its + 1, key=s_.key,
            )

        final = lax.while_loop(cond_fn, body_fn, st)
        status = jnp.where(
            final.resmax <= tol,
            jnp.int32(Status.CONVERGED),
            jnp.int32(Status.INSUFFICIENT_ITER),
        )
        # return the wanted pairs ascending regardless of search direction,
        # scipy-style (buffer columns are iteration scaffolding, not results)
        lam_w, X_w = final.lam[:k_want], final.X[:, :k_want]
        order = jnp.argsort(lam_w)
        return (
            lam_w[order],
            X_w[:, order],
            make_info(final.its, final.resmax, status),
        )
