"""s-step (communication-avoiding) Conjugate Gradients.

Not in the reference (its SPD solver is MINRES, ``src/minres.rs``); this is
the mesh-latency end of the CG family this package builds out:

- :func:`~sprsolve_tpu.solvers.cg.cg` — 2 dependent all-reduce rounds/iter,
- :func:`~sprsolve_tpu.solvers.cg.cg_single_sync` — 1 fused round/iter
  (Chronopoulos–Gear),
- ``ca_cg`` (here) — **1 all-reduce round per s iterations** (Carson &
  Demmel's CA-KSM formulation): per outer block, build the 2s+1 Krylov
  basis vectors V = [ρ₀(A)p … ρ_s(A)p, ρ₀(A)r … ρ_{s−1}(A)r], form the
  (2s+1)² Gram matrix G = VᴴV with ONE ``psum``, then run s exact-CG steps
  as *scalar* coefficient recurrences against replicated G (A·(V·a) = V·B·a
  with B the static basis-change matrix), and reconstruct x/r/p with three
  local (m × 2s+1) GEMVs — tall-skinny matmuls.

On a banded operator with matrix-powers support
(:class:`~sprsolve_tpu.parallel.dist_operator.MPKDIA`) the basis itself
needs only ONE depth-s·h halo exchange (2 ``ppermute``s) instead of the 2s
of s plain SpMVs, so a whole block of s CG iterations costs 2 ppermutes +
1 all-reduce — vs s·(2 ppermutes + 2 all-reduces) for plain CG.  Certified
from compiled HLO in ``tests/test_ca_cg.py``.

Single-device cost: the basis build applies A to the stacked [p, r]
2-column block s times per s iterations — ~2× plain CG's SpMV work — and
on one device that is pure cost.  This solver's regime is a mesh where
reduction/halo latency dominates; on a single device prefer :func:`cg`.

Basis conditioning is the classical CA trade: the monomial basis ρ_j = λʲ
has condition growing like κ(A)^s, so the default is the **Chebyshev basis**
on a spectral interval [lo, hi] (pass ``bounds``; Gershgorin bounds are
free host-side — :func:`sprsolve_tpu.gershgorin_bounds`), whose basis vectors
stay O(1).  Residual drift is handled the package's standard way
(``idrs.py``): the recurrence loop exits on the coordinate norm
rᴴGr, an outer loop re-anchors on the TRUE residual b − A·x, and
CONVERGED is gated on the true residual only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..errors import Status
from ..vecalg import axpy, conj_dot, eps_for, norm2
from .common import check_shapes, make_info

_HI = lax.Precision.HIGHEST


def _basis_change(s: int, basis: str, theta: float, delta: float) -> np.ndarray:
    """Static B with A·V[:, j] = Σ_i B[i, j]·V[:, i] on the valid columns.

    Block-diagonal over the p-chain (s+1 columns) and r-chain (s columns);
    the highest column of each chain maps out of the space and is never
    touched by the recurrences (coefficient degrees stay ≤ s−1 before the
    final multiply), so those columns are left zero.
    """
    t = 2 * s + 1
    B = np.zeros((t, t))

    def chain(off: int, size: int) -> None:
        for j in range(size - 1):
            c = off + j
            if basis == "monomial":
                B[c + 1, c] = 1.0
            else:  # chebyshev: ρ₀=1, ρ₁=(A−θ)/δ, ρ_{j+1}=2(A−θ)/δ·ρ_j − ρ_{j−1}
                B[c, c] = theta
                B[c + 1, c] = delta if j == 0 else delta / 2.0
                if j >= 1:
                    B[c - 1, c] = delta / 2.0

    chain(0, s + 1)
    chain(s + 1, s)
    return B


def fold_jacobi(A, b, x0=None):
    """Fold a Jacobi preconditioner into the system by symmetric diagonal
    scaling: Ā = D^{-1/2}·A·D^{-1/2}, b̄ = D^{-1/2}·b, x = D^{-1/2}·x̄.

    This is THE way to precondition an s-step solver with Jacobi: a
    preconditioned CA basis needs M-polynomial machinery, but running
    plain ``ca_cg`` on the symmetrically scaled system reproduces
    Jacobi-CG's convergence (same Krylov space in the D-inner product)
    while leaving the block structure — and its 1-all-reduce /
    2-ppermute per s-block collective counts — unchanged.

    Host-side O(nnz), built once per system.  Returns
    ``(A_scaled, b_scaled, x0_scaled, unfold)`` with ``x = unfold(x̄)``.
    ``A`` must be a host CSR container with a positive(-magnitude)
    diagonal (SPD/HPD systems — ``ca_cg``'s domain).

    Convergence semantics: the solver's ``tol`` then applies to the
    residual of the SCALED system, ‖D^{-1/2}(b − A·x)‖ / ‖D^{-1/2}b‖ —
    i.e. the *preconditioned* residual norm, the same criterion PETSc's
    KSP uses by default under left preconditioning.  The original-system
    relative residual can sit up to ~κ(D)^{1/2} above it; tighten ``tol``
    if the unscaled norm is what you need.
    """
    from ..sparse.containers import CSR

    d = np.asarray(A.diagonal())
    mag = np.abs(d).astype(np.float64)
    mag[mag == 0] = 1.0
    s_host = 1.0 / np.sqrt(mag)
    rows = np.asarray(A.row_ids, dtype=np.int64)
    cols = np.asarray(A.indices, dtype=np.int64)
    data = np.asarray(A.data) * (s_host[rows] * s_host[cols])
    A_s = CSR.from_arrays(
        data.astype(np.asarray(A.data).dtype), A.indices, A.indptr, A.shape
    )
    rdt = jnp.finfo(jnp.asarray(b).dtype).dtype if not jnp.iscomplexobj(
        jnp.asarray(b)
    ) else jnp.real(jnp.asarray(b)).dtype
    s_dev = jnp.asarray(s_host, dtype=rdt)
    b_s = jnp.asarray(b) * s_dev
    x0_s = None if x0 is None else jnp.asarray(x0) / s_dev

    def unfold(x_s):
        return x_s * s_dev

    return A_s, b_s, x0_s, unfold


class _State(NamedTuple):
    x: jax.Array
    r: jax.Array       # recurrence residual (re-anchored exactly each outer)
    p: jax.Array
    rn2: jax.Array     # real scalar ‖r‖² (exact at outer anchors)
    its: jax.Array
    status: jax.Array
    hist: jax.Array


def ca_cg(
    A,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    s: int = 4,
    basis: str = "auto",
    bounds=None,
    tol,
    max_iter,
    axis_name: Optional[str] = None,
    record_residuals: bool = False,
):
    """Solve SPD/HPD A·x = b with s-step CG. Returns ``(x, SolveInfo)``.

    ``s``: CG iterations per communication block (static; 2–8 sensible).
    ``basis``: ``"chebyshev"`` (needs ``bounds=(lo, hi)`` containing the
    spectrum — Gershgorin is fine), ``"monomial"``, or ``"auto"``
    (chebyshev when bounds are given, else monomial).  ``bounds`` are
    static floats.

    Unpreconditioned (the preconditioned CA-CG basis needs M-polynomial
    machinery out of scope here — use :func:`cg`/:func:`cg_single_sync`
    with M instead).  Convergence: TRUE relative residual ≤ tol, exactly
    like the package's other honest-gate solvers.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    check_shapes(A, b, x0, axis_name)
    if b.ndim != 1:
        from ..errors import IncompatibleMatrixFormat

        raise IncompatibleMatrixFormat(
            "ca_cg works on flat vectors (the basis block stacks p and r); "
            "padded kernel layouts are not supported here"
        )
    if s < 1:
        raise ValueError(f"need s >= 1, got {s}")
    if basis == "auto":
        basis = "chebyshev" if bounds is not None else "monomial"
    if basis == "chebyshev":
        if bounds is None:
            raise ValueError("basis='chebyshev' needs bounds=(lo, hi)")
        lo, hi = float(bounds[0]), float(bounds[1])
        theta = 0.5 * (hi + lo)
        delta = max(0.5 * (hi - lo), 1e-30)
    elif basis == "monomial":
        theta, delta = 0.0, 1.0
    else:
        raise ValueError(f"unknown basis {basis!r}")
    if hasattr(A, "max_power") and s > A.max_power:
        raise ValueError(
            f"s={s} exceeds the operator's matrix-powers depth "
            f"{A.max_power} (ext={A.ext}, halo={A.halo})"
        )

    T = b.dtype
    rdt = jnp.finfo(T).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    tol = jnp.asarray(tol, dtype=rdt)
    hist_len = int(max_iter) + 1 if record_residuals else 0
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    eps = eps_for(T)
    tiny = jnp.asarray(jnp.finfo(rdt).tiny, rdt)
    t = 2 * s + 1
    Bmat = jnp.asarray(_basis_change(s, basis, theta, delta), rdt)
    mpk = hasattr(A, "mpk_extend") and axis_name is not None
    one = jnp.ones((), T)

    def basis_block(p, r):
        """V = [ρ₀(A)p … ρ_s(A)p, ρ₀(A)r … ρ_{s−1}(A)r] as (m, 2s+1)."""
        Z = jnp.stack([p, r], axis=1)
        if mpk:
            cur = A.mpk_extend(Z)       # ONE exchange for the whole chain
            apply_, central = A.mpk_apply, A.mpk_central
        else:
            cur = Z
            apply_ = A.matmat if hasattr(A, "matmat") else (
                lambda X: jax.vmap(A.matvec, in_axes=1, out_axes=1)(X)
            )
            central = lambda v: v  # noqa: E731
        chain = [cur]
        for j in range(s):
            Av = apply_(chain[-1])
            if basis == "monomial":
                nxt = Av
            elif j == 0:
                nxt = (Av - theta * chain[-1]) / delta
            else:
                nxt = (2.0 / delta) * (Av - theta * chain[-1]) - chain[-2]
            chain.append(nxt)
        cols = [central(c)[:, 0] for c in chain]            # p-chain, s+1
        cols += [central(c)[:, 1] for c in chain[:s]]       # r-chain, s
        return jnp.stack(cols, axis=1)

    def gram(V):
        G = jnp.matmul(V.conj().T, V, precision=_HI)
        if axis_name is not None:
            G = lax.psum(G, axis_name)
        return G

    def main(rhs_norm):
        tol2sq = jnp.square(tol * rhs_norm)

        r0 = axpy(-one, A.matvec(x0), b)
        rn2_0 = jnp.real(conj_dot(r0, r0, axis_name))
        st0 = _State(
            x=x0, r=r0, p=r0, rn2=rn2_0,
            its=jnp.int32(0), status=jnp.int32(Status.RUNNING),
            hist=jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

        def cond_fn(st):
            return (
                (st.status == Status.RUNNING)
                & (st.its < max_iter)
                & (st.rn2 > tol2sq)
            )

        def body_fn(st):
            V = basis_block(st.p, st.r)
            G = gram(V)                     # the block's ONE all-reduce
            a = jnp.zeros(t, T).at[0].set(1.0)
            bv = jnp.zeros(t, T).at[s + 1].set(1.0)
            c = jnp.zeros(t, T)
            num = jnp.real(bv.conj() @ (G @ bv))
            its, status, hist = st.its, st.status, st.hist
            active = jnp.asarray(True)
            for _ in range(s):
                w = (Bmat @ a).astype(T)  # real B × (possibly complex) a
                den = jnp.real(a.conj() @ (G @ w))
                ok = den > 0
                step = active & ok & (its < max_iter)
                alpha = (num / jnp.where(den > 0, den, 1.0)).astype(T)
                c = jnp.where(step, c + alpha * a, c)
                bnew = jnp.where(step, bv - alpha * w, bv)
                num_new = jnp.maximum(jnp.real(bnew.conj() @ (G @ bnew)), 0.0)
                beta = (num_new / jnp.maximum(num, tiny)).astype(T)
                a = jnp.where(step, bnew + beta * a, a)
                bv = bnew
                if hist_len:
                    idx = jnp.minimum(its, max_iter)
                    hist = hist.at[idx].set(jnp.where(
                        step, jnp.sqrt(num) / rhs_norm, hist[idx]
                    ))
                status = jnp.where(
                    active & ~ok, jnp.int32(Status.BREAKDOWN), status
                )
                its = jnp.where(step, its + 1, its)
                num = jnp.where(step, num_new, num)
                active = step & (num > tol2sq)
            # reconstruct the iterates — three local tall-skinny GEMVs
            x = st.x + jnp.matmul(V, c, precision=_HI)
            r = jnp.matmul(V, bv, precision=_HI)
            p = jnp.matmul(V, a, precision=_HI)
            return _State(
                x=x, r=r, p=p, rn2=num, its=its, status=status, hist=hist,
            )

        # Outer re-anchor loop (the idrs.py pattern): the block loop exits
        # on the COORDINATE norm rᴴGr, whose drift from the true residual
        # is the classical s-step failure mode; each outer pass recomputes
        # b − A·x exactly and restarts with p = r (steepest-descent
        # restart), so the recurrence re-anchors and the solver keeps
        # iterating until the TRUE residual meets tol.
        def outer_cond(o):
            return (
                (o.status == Status.RUNNING)
                & (o.its < max_iter)
                & (o.rn2 > tol2sq)
            )

        def outer_body(o):
            inner = lax.while_loop(cond_fn, body_fn, o)
            r_true = axpy(-one, A.matvec(inner.x), b)
            rn2 = jnp.real(conj_dot(r_true, r_true, axis_name))
            return _State(
                x=inner.x, r=r_true, p=r_true, rn2=rn2,
                its=inner.its + 1, status=inner.status, hist=inner.hist,
            )

        final = lax.while_loop(outer_cond, outer_body, st0)
        # final.rn2 is always TRUE: the initial state's is ‖b − A·x0‖² and
        # every outer_body recomputes it.
        true_res = jnp.sqrt(final.rn2) / rhs_norm
        converged = (final.status == Status.RUNNING) & (true_res <= tol)
        status = jnp.where(
            converged,
            jnp.int32(Status.CONVERGED),
            jnp.where(
                final.status == Status.RUNNING,
                jnp.int32(Status.INSUFFICIENT_ITER),
                final.status,
            ),
        )
        hist = final.hist
        if hist_len:
            idx = jnp.minimum(final.its, max_iter)
            hist = hist.at[idx].set(jnp.where(
                converged, true_res, hist[idx]
            ))
        return final.x, make_info(final.its, true_res, status), hist

    rhs_norm = norm2(b, axis_name)

    def trivial(_):
        return (
            jnp.zeros_like(x0),
            make_info(0, rhs_norm, Status.CONVERGED),
            jnp.full(hist_len, jnp.nan, dtype=rdt),
        )

    x, info, hist = lax.cond(
        rhs_norm <= eps, trivial, lambda _: main(rhs_norm), None
    )
    if record_residuals:
        return x, info, hist
    return x, info
