"""Rational-filter (FEAST-style) interior eigensolver.

Beyond the reference (no eigensolver surface) and beyond
:func:`~sprsolve_tpu.solvers.eigs.shift_invert_eigs`: interior eigenpairs of
a deep-spectrum Hermitian operator are the one place shift-invert is
honest-but-slow, because
MINRES on the *indefinite* real shift A − σI is condition-bound by the gap
to the nearest eigenvalue, and no SPD preconditioner available to MINRES
helps (the Poisson diagonal is constant; multigrid needs definiteness).

The fix is the production method used by Intel FEAST / contour-integral
eigensolvers (Polizzi 2009): approximate the spectral projector onto the
eigenspace inside a disc around σ by a quadrature of the resolvent,

    ρ(A)·Y = (1/2πi) ∮_C (zI − A)⁻¹ Y dz  ≈  Σⱼ wⱼ·Re[(zⱼI − A)⁻¹ Y],

then run subspace iteration + Rayleigh–Ritz on the filtered block.  The
numerical point: every quadrature node zⱼ sits OFF the real axis, so each
inner system has κ(zⱼI − A) ≤ ‖A‖ / |Im zⱼ| regardless of how densely
real eigenvalues crowd σ.  The inner solves trade one hard indefinite
real system for a handful of complex-symmetric ones.

**Regime (be honest about both halves):** the filter's radius must hold ~k eigenvalues, so r ~ k·Δ with Δ the local
eigenvalue SPACING at σ, and Im zⱼ ~ aspect·r.  When Δ is comfortably
larger than machine-precision scales (moderate n, or σ in a sparse part
of the spectrum), the inner COCG solves converge in O(√κ) iterations and
the method delivers machine-grade interior pairs (exact to 1e-15 vs dense
oracles on CPU).  Deep
interior at LARGE n (262k: Δ ≈ 1.4e-4), the displaced spectrum
(λ − σ) + i·Im z is both sign-INDEFINITE in its real part and dense on
the scale of Im z, and Krylov iteration counts scale like √(κ₊·κ₋) ≈
16,000 per node — FEAST needs *accurate* resolvents where shift-invert's
LOBPCG tolerates sloppy ones (600-iteration MINRES applies), so
:func:`shift_invert_eigs` owns that regime.

Composition (no new kernels needed):

- zI − A for real-symmetric A is complex *symmetric* → the inner solver is
  this package's :func:`~sprsolve_tpu.solvers.cocg.cocg` (one SpMV/iter).
- The complex matvec decomposes onto the REAL fast path: (zI − A)x costs
  two real SpMVs (re/im planes) on the XLA DIA operator — no complex
  operator variant required.
- The m0 right-hand sides run as one ``vmap``-batched COCG (lockstep
  ``lax.while_loop``), so the matrix stream is amortized across the block —
  SpMM economics, the same reason LOBPCG beats vector-at-a-time Lanczos
  on this hardware.
- Quadrature nodes are passed as ARRAYS (σ, r change without recompiling);
  only n_quad/m0 shape the compiled program.

Accuracy contract matches ``shift_invert_eigs``: CONVERGED is gated on the
directly measured residuals ‖A·x − λx‖/|λ| of the returned pairs on the
original A.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import IncompatibleMatrixFormat
from .cocg import cocg

# env-gated per-iteration diagnostics (radius walk, Ritz spectrum, residuals)
import os as _os

_RF_DEBUG = bool(_os.environ.get("SPRSOLVE_RF_DEBUG"))
from .eigs import _select_nearest

_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class _ComplexShifted:
    """(zr + i·zi)I − A on complex vectors, via two REAL A-applies.

    A is a real(-dtype) flat-vector operator; the complex-symmetric
    structure COCG needs follows from Aᵀ = A.
    """

    A: object
    zr: jax.Array
    zi: jax.Array

    @property
    def shape(self):
        return self.A.shape

    def matvec(self, x: jax.Array) -> jax.Array:
        xr, xi = jnp.real(x), jnp.imag(x)
        Axr = self.A.matvec(xr)
        Axi = self.A.matvec(xi)
        return (self.zr * xr - self.zi * xi - Axr) + 1j * (
            self.zr * xi + self.zi * xr - Axi
        )

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)


jax.tree_util.register_dataclass(
    _ComplexShifted, data_fields=("A", "zr", "zi"), meta_fields=()
)


def _gauss_semicircle(n_quad: int, aspect: float = 1.0):
    """Gauss–Legendre nodes/weights for the upper half of an ELLIPTIC
    contour: z(θ) = σ + r·(cos θ + i·aspect·sin θ).

    Returns complex constants ``(c_j, d_j)`` with z_j = σ + r·c_j and the
    filter applied as  ρ(A)·Y ≈ Σⱼ Re[r·d_j · (z_jI − A)⁻¹ Y]:
    ρ(λ) = (1/2πi)∮ dz/(z−λ), dz = r·(−sin θ + i·aspect·cos θ)dθ, and
    conjugate symmetry of the real-λ integrand folds the lower half onto
    the upper (factor 2).

    ``aspect`` is the decisive conditioning knob at scale: for REAL
    spectra only the contour's real-axis crossings σ ± r matter (ρ is 1
    on (σ−r, σ+r) and 0 outside for ANY height), while the inner systems'
    κ ≈ ‖A‖/|Im z_j| shrinks ∝ aspect.  A taller contour softens the
    filter's edge slightly (slower subspace convergence for pairs hugging
    the boundary) — a measured win ≥2-3× in inner iterations at the 262k
    bench scale.
    """
    t, v = np.polynomial.legendre.leggauss(n_quad)
    theta = np.pi * (t + 1.0) / 2.0          # (0, π)
    c = np.cos(theta) + 1j * aspect * np.sin(theta)
    # (1/2πi)·2·(π/2)·v_j·dz/dθ / r  =  (v_j/2i)·(−sinθ + i·aspect·cosθ)
    d = (v / 2.0) * (aspect * np.cos(theta) + 1j * np.sin(theta))
    return c, d


def rational_filter_eigs(
    A,
    k: int,
    sigma: float,
    *,
    radius: Optional[float] = None,
    side: str = "both",
    m0: Optional[int] = None,
    n_quad: int = 6,
    inner_tol: Optional[float] = None,
    inner_max_iter: int = 600,
    contour_aspect: float = 3.0,
    inner_dtype=None,
    inner_refine: int = 0,
    tol: float = 1e-6,
    max_iter: int = 8,
    optimize_layout: bool = True,
    seed: int = 0,
):
    """The ``k`` eigenpairs of real-symmetric ``A`` nearest ``sigma``.

    Same return contract as :func:`shift_invert_eigs`: ``(lam, X, info)``
    with eigenvalues ordered by |λ − σ|, ``info.residual`` the worst
    measured A-residual of the returned pairs, ``info.iterations`` the
    TOTAL inner COCG iterations across all quadrature solves (the honest
    cost unit — each is one complex SpMV = two real SpMVs).

    ``radius``: half-width of the search disc around σ.  ``None``
    auto-calibrates: start from a small fraction of the Gershgorin width
    and expand/shrink between subspace iterations until the disc holds
    roughly ``k``–``m0`` Ritz values.  ``m0`` (subspace size, default
    ``max(2k, k+6)``) must exceed the number of eigenvalues in the final
    disc for the classical FEAST convergence argument to apply.
    ``max_iter`` caps *subspace* iterations (FEAST typically needs 2-4
    once the radius is right).

    ``contour_aspect`` (default 3): vertical stretch of the elliptic
    contour.  For real spectra only the crossings σ ± r matter, while the
    inner systems' κ ≈ ‖A‖/|Im z| shrinks ∝ aspect — the cheap
    conditioning knob.  ``inner_max_iter`` must cover the NEAR-AXIS
    node: budget ≈ √κ·ln(2/inner_tol)/2 with
    κ ≈ (hi−lo)/(r·aspect·sin θ_min); the tol exit makes a generous
    ceiling free.

    At large scale + small radius, κ exceeds what f32 Krylov can resolve
    (attainable residual ≈ ε·κ).  Two escapes:

    - ``inner_refine=p``: each node solve runs ``p`` mixed-precision
      refinement passes — c64 COCG inner sweeps + straight-line
      complex128 true-residual corrections on the XLA f64 DIA operator
      (no f64 while_loops).  The f32 solver floor ε·κ drops to the
      ~1e-7 representation floor at ~2-3× the f32 iteration count.
      Needs ``jax_enable_x64`` and a CSR/CSC input.
    - ``inner_dtype="float64"``: run the whole filter in f64.  Which of
      the two is faster on a card with native f64 is not measured yet.
    """
    if k < 1:
        raise IncompatibleMatrixFormat(f"need k >= 1, got {k}")
    if side not in ("both", "above", "below"):
        raise IncompatibleMatrixFormat(
            f"side must be 'both', 'above' or 'below', got {side!r}"
        )
    if m0 is None:
        m0 = max(2 * k, k + 6)
    if m0 < k:
        raise IncompatibleMatrixFormat(f"need m0 >= k, got m0={m0} < k={k}")
    if inner_tol is None:
        inner_tol = min(tol * 1e-2, 1e-7)

    from ..sparse.containers import CSC, CSR
    from ..utils.bounds import gershgorin_bounds

    op = A
    bounds = None
    if isinstance(op, CSC):
        op = op.to_csr()
    op64 = None
    if inner_refine:
        if not isinstance(op, CSR):
            raise IncompatibleMatrixFormat(
                "inner_refine needs a CSR/CSC input (the f64 residual "
                "operator is built from it)"
            )
        if not jax.config.jax_enable_x64:
            raise IncompatibleMatrixFormat(
                "inner_refine needs jax_enable_x64 (f64 true residuals)"
            )
        import dataclasses as _dc

        src64 = _dc.replace(
            op, data=jnp.asarray(np.asarray(op.data), jnp.float64)
        )
        try:
            op64 = src64.to_dia()    # straight-line XLA f64 SpMM only
        except ValueError:
            op64 = src64
    if inner_dtype is not None:
        idt = jnp.dtype(inner_dtype)
        if not isinstance(op, CSR):
            raise IncompatibleMatrixFormat(
                "inner_dtype override needs a CSR/CSC input (the operator "
                "is rebuilt at that dtype)"
            )
        if idt == jnp.dtype(jnp.float64) and not jax.config.jax_enable_x64:
            raise IncompatibleMatrixFormat(
                "inner_dtype='float64' needs jax_enable_x64"
            )
        import dataclasses as _dc

        bounds = gershgorin_bounds(op)
        src = _dc.replace(op, data=jnp.asarray(np.asarray(op.data), idt))
        try:
            op = src.to_dia()     # XLA DIA path at the requested dtype
        except ValueError:
            op = src
    elif isinstance(op, CSR):
        bounds = gershgorin_bounds(op)
        if optimize_layout:
            from ..ops.optimize import optimize as _optimize

            op = _optimize(op)
    if hasattr(op, "pad_vec"):
        from ..multigrid import FlatViewOperator

        op = FlatViewOperator(op=op)
    n = op.shape[0]

    dt = getattr(op, "dtype", None)
    if dt is None and hasattr(op, "op"):
        dt = getattr(op.op, "dtype", None)
    if dt is None:
        dt = jnp.float64
    rdt = jnp.dtype(dt)
    if rdt not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
        raise IncompatibleMatrixFormat(
            "rational_filter_eigs needs a real symmetric operator "
            f"(dtype {rdt}); for Hermitian complex use shift_invert_eigs"
        )

    c_np, d_np = _gauss_semicircle(int(n_quad), float(contour_aspect))

    rng = np.random.default_rng(seed)
    Y0 = jnp.asarray(rng.standard_normal((n, m0)), rdt)

    def _solve_node(Yc, zr, zi):
        opz = _ComplexShifted(A=op, zr=zr, zi=zi)
        solve_col = lambda y: cocg(
            opz, y, tol=inner_tol, max_iter=inner_max_iter
        )
        X, infos = jax.vmap(solve_col, in_axes=1, out_axes=(1, 0))(Yc)
        return X, jnp.sum(infos.iterations).astype(jnp.int32)

    def _one_node(Yc, zr, zi):
        if not inner_refine:
            return _solve_node(Yc, zr, zi)
        # mixed-precision refinement: the c64 COCG sweep floors out at
        # ~ε₃₂·κ relative accuracy; a straight-line f64 true residual
        # against the f64 operator restarts the sweep on the correction
        # and multiplies the accuracy per pass.  The f64 state is carried
        # as real planes with straight-line f64 SpMM only (no f64 control
        # flow, no c64↔c128 converts).  The result returns
        # as c64: ~1e-7 representation accuracy, far below the filter's
        # needs.
        zr64 = zr.astype(jnp.float64)
        zi64 = zi.astype(jnp.float64)
        cr = jnp.float32 if Yc.dtype == jnp.complex64 else jnp.float64

        X, its = _solve_node(Yc, zr, zi)
        Xr = jnp.real(X).astype(jnp.float64)
        Xi = jnp.imag(X).astype(jnp.float64)
        Yr = jnp.real(Yc).astype(jnp.float64)
        Yi = jnp.imag(Yc).astype(jnp.float64)
        for _ in range(int(inner_refine)):
            AXr = op64.matmat(Xr)
            AXi = op64.matmat(Xi)
            Rr = Yr - (zr64 * Xr - zi64 * Xi - AXr)
            Ri = Yi - (zr64 * Xi + zi64 * Xr - AXi)
            Rc = Rr.astype(cr) + 1j * Ri.astype(cr)
            D, itd = _solve_node(Rc, zr, zi)
            Xr = Xr + jnp.real(D).astype(jnp.float64)
            Xi = Xi + jnp.imag(D).astype(jnp.float64)
            its = its + itd
        # return f64 PLANES: the resolvent is near-singular, so ‖X‖ ~
        # ‖Y‖/Im z ≫ ‖Y‖ and an f32 cast HERE injects ε₃₂·‖X‖ noise that
        # survives the quadrature's cross-node cancellation — the measured
        # few-e-3 Ritz floor that made refinement look like a no-op.  The
        # caller accumulates Q in f64 (where the cancellation happens) and
        # only then casts the O(‖Y‖)-sized Q down.
        return (Xr, Xi), its

    @partial(jax.jit, static_argnames=())
    def filter_and_ritz(Y, r):
        """One subspace iteration: Q = ρ(A)Y, Rayleigh–Ritz on Q."""
        cdt = jnp.complex64 if rdt == jnp.dtype(jnp.float32) else jnp.complex128
        Yc = Y.astype(cdt)
        its = jnp.int32(0)
        if inner_refine:
            # f64-plane accumulation (see _one_node): the per-node X are
            # near-singular-sized and cancel across nodes — sum first,
            # cast the O(‖Y‖)-sized Q after
            Q64 = jnp.zeros(Y.shape, jnp.float64)
            r64 = r.astype(jnp.float64)
            for j in range(int(n_quad)):
                zr = sigma + r * jnp.asarray(c_np[j].real, rdt)
                zi = r * jnp.asarray(c_np[j].imag, rdt)
                (Xr64, Xi64), itj = _one_node(Yc, zr, zi)
                Q64 = Q64 + r64 * (
                    float(d_np[j].real) * Xr64 - float(d_np[j].imag) * Xi64
                )
                its = its + itj.astype(jnp.int32)
            Q = Q64.astype(rdt)
        else:
            Q = jnp.zeros_like(Y)
            for j in range(int(n_quad)):   # static unroll, n_quad small
                zr = sigma + r * jnp.asarray(c_np[j].real, rdt)
                zi = r * jnp.asarray(c_np[j].imag, rdt)
                Xj, itj = _one_node(Yc, zr, zi)
                Q = Q + r * jnp.real(jnp.asarray(d_np[j], cdt) * Xj)
                its = its + itj.astype(jnp.int32)
        # orthonormalize the filtered block (random noise fills directions
        # the filter killed — harmless, RR sorts them outside the disc).
        # CholQR2 instead of tall QR: only m0×m0 factorizations, with a
        # tiny trace-scaled ridge for filter-annihilated directions
        def _cholqr(B):
            G = jnp.matmul(B.T, B, precision=_HI)
            eps_r = jnp.asarray(
                np.finfo(np.dtype(rdt)).eps * 100, rdt
            ) * jnp.trace(G)
            L = jnp.linalg.cholesky(
                G + eps_r * jnp.eye(G.shape[0], dtype=rdt)
            )
            return jax.scipy.linalg.solve_triangular(L, B.T, lower=True).T

        Qo = _cholqr(_cholqr(Q))
        AQ = (
            op.matmat(Qo)
            if hasattr(op, "matmat")
            else jax.vmap(op.matvec, in_axes=1, out_axes=1)(Qo)
        )
        H = jnp.matmul(Qo.T, AQ, precision=_HI)
        H = 0.5 * (H + H.T)
        lam, W = jnp.linalg.eigh(H)
        V = jnp.matmul(Qo, W, precision=_HI)
        AV = jnp.matmul(AQ, W, precision=_HI)
        R = AV - V * lam[None, :]
        rel = jnp.linalg.norm(R, axis=0) / jnp.maximum(
            jnp.abs(lam), jnp.finfo(rdt).tiny
        )
        # stochastic eigencount: E[yᵀρ(A)y] = tr ρ(A) ≈ #eigs inside the
        # disc when Y is the standard-normal block (ONLY then — the host
        # loop tracks that).  One dot per column, drives the one-shot
        # radius calibration below.
        est = jnp.sum(Y * Q) / Y.shape[1]
        return V, lam, rel, its, est

    # initial radius: user-given, else a small slice of the spectrum width
    if radius is not None:
        r_cur = float(radius)
        calibrate = False
    else:
        if bounds is None:
            raise IncompatibleMatrixFormat(
                "radius=None auto-calibration needs a CSR/CSC input "
                "(Gershgorin seed); pass radius= for a bare operator"
            )
        r_cur = max((bounds[1] - bounds[0]) * 1e-3, 1e-12)
        calibrate = True

    total_inner = 0
    best = None
    Y = Y0
    y_is_random = True
    # aim the disc at slightly more than k eigenvalues, leaving ≥ 2/3 of
    # the (m0 − k) columns as the convergence buffer the classical FEAST
    # rate ρ(λ_{m0+1})/ρ(λ_k) depends on (an overfull disc starves it)
    target = k + max(1.0, (m0 - k) / 3.0)
    calib_left = 6
    for _ in range(int(max_iter)):
        V, lam, rel, its, est = filter_and_ritz(Y, jnp.asarray(r_cur, rdt))
        total_inner += int(its)
        lam_np = np.asarray(lam)
        rel_np = np.asarray(rel)
        inside = np.abs(lam_np - sigma) <= r_cur
        if side == "above":
            inside &= lam_np >= sigma
        elif side == "below":
            inside &= lam_np < sigma
        n_in = int(inside.sum())
        best = (lam_np, rel_np, np.asarray(V))
        if _RF_DEBUG:
            import sys as _sys

            _o = np.argsort(np.abs(lam_np - sigma))[:6]
            print(
                f"rf: r={r_cur:.3e} n_in={n_in} est={float(est):.1f} "
                f"lam6={np.round(lam_np[_o], 6)} rel6={rel_np[_o]}",
                file=_sys.stderr, flush=True,
            )
        # done when the k nearest NON-GHOST pairs inside the disc meet
        # tol.  A ghost — a spurious boundary Ritz value, the classical
        # FEAST artifact, with a residual orders above tol that never
        # improves — is excluded from the candidate set so it cannot
        # block termination; a merely slow real pair (within the ghost
        # threshold but above tol) still does, and the loop keeps
        # iterating until it converges.
        ghost_thr = max(10.0 * tol, float(np.sqrt(np.finfo(rdt).eps)))
        cand = np.where(inside & (rel_np <= ghost_thr))[0]
        cand = cand[np.argsort(np.abs(lam_np[cand] - sigma))][:k]
        if (
            len(cand) >= 1
            and (len(cand) >= k or not calibrate)
            and bool(np.all(rel_np[cand] <= tol))
        ):
            break
        if calibrate and calib_left > 0 and (n_in < k or n_in > m0 - 2):
            calib_left -= 1
            # one-shot proportional correction, assuming locally-linear
            # eigenvalue density: count(r) ∝ r.  The Ritz count saturates
            # at m0, so when Y was the random block prefer the unbiased
            # stochastic trace estimate (can be ≫ m0 for an oversized
            # disc, landing the correction in one step instead of a
            # geometric walk — each walk step costs a full set of inner
            # solves).
            count = float(n_in)
            if y_is_random:
                count = max(count, float(est))
            count = max(count, 0.5)
            r_cur *= float(np.clip(target / count, 0.05, 20.0))
            Y = Y0          # restart from the random block: keeps the
            y_is_random = True  # trace estimator valid next pass
            continue
        Y = V  # plain subspace iteration on the Ritz block
        y_is_random = False

    lam_np, rel_np, Vnp = best
    # disc filter + GHOST filter: a Ritz value whose measured A-residual
    # sits orders above tol is a spurious boundary artifact (the filter's
    # soft edge), not an eigenpair — returning it as a "nearest" pair
    # would be garbage-with-a-label.  Dropping it either leaves k real
    # pairs (CONVERGED) or fewer (honest INSUFFICIENT_ITER).
    order_keep = (np.abs(lam_np - sigma) <= r_cur) & (
        rel_np <= max(10.0 * tol, np.sqrt(np.finfo(rdt).eps))
    )
    # pack exactly like shift_invert_eigs (side filter, |λ−σ| order,
    # dedupe, measured-residual CONVERGED gate)
    return _select_nearest(
        lam_np[order_keep], rel_np[order_keep], Vnp[:, order_keep],
        sigma, side, k, tol, total_inner,
    )
