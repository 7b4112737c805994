"""Distributed eigensolver driver: shard_map LOBPCG over a row-partitioned
operator.

The reference has no eigensolver (its surface is linear solvers,
``src/lib.rs:15-21``) and no distributed runtime (``Cargo.toml:14-28``);
this extends the package's own LOBPCG surface (COVERAGE.md "Beyond the
reference") to the same row-partition axis every distributed solve uses.

Structure of one distributed iteration (certified from compiled HLO in
``tests/test_dist_lobpcg.py``):

- the (n_local, 3k) block SpMM does ONE halo exchange for the whole block
  (``HaloDIA.matmat`` — 2 collective-permutes regardless of k, overlapped
  with the interior band products by XLA's scheduler);
- every k×k / 3k×3k Gram matrix is one ``psum`` (all-reduce of ≤ (3k)²
  scalars — latency-bound, not bandwidth-bound);
- QR of the row-sharded basis is shifted CholQR2 (Gram + replicated
  Cholesky + local triangular solve, twice) — no tall-skinny gather;
- the 3k×3k Rayleigh–Ritz eigenproblem is solved redundantly per device
  from replicated inputs, so eigenvalues/SolveInfo come back replicated.

Padding: n is padded to the mesh size with DECOUPLED rows whose diagonal
sits strictly outside the wanted end of the spectrum (Gershgorin bound), so
pad eigenpairs can never be selected by Rayleigh–Ritz; pad rows of X0 start
at zero and only re-enter through the rank-refresh path, where the spectral
placement makes them contract away again.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..errors import SolveInfo
from ..precond import DiagPrecond
from ..solvers.lobpcg import lobpcg
from ..sparse.containers import CSR, DIA
from ..utils.bounds import gershgorin_bounds
from .dist_operator import (
    AllGatherELL, HaloDIA, auto_mesh, partition_csr, partition_dia,
)


_gershgorin_bounds = gershgorin_bounds  # shared host-side estimate


def _pad_rows(A_parts, n: int, largest: bool, bounds) -> "AllGatherELL | HaloDIA":
    """Rewrite identity pad rows (from partition_*) so the pad diagonal sits
    strictly outside the wanted end of the spectrum."""
    lo, hi = bounds
    span = max(hi - lo, 1.0)
    pad_val = (lo - span) if largest else (hi + span)
    return _set_pad_diag(A_parts, n, pad_val)


def _set_pad_diag(A_parts, n: int, pad_val: float) -> "AllGatherELL | HaloDIA":
    """Rewrite the pad rows' diagonal (identity after partition_*) to
    ``pad_val``; the pad rows stay decoupled from the real ones."""
    n_pad = A_parts.shape[0]
    if n_pad == n:
        return A_parts
    if isinstance(A_parts, HaloDIA):
        d0 = A_parts.offsets.index(0)
        bands = A_parts.bands.at[d0, n:].set(
            jnp.asarray(pad_val, A_parts.bands.dtype)
        )
        return HaloDIA(
            bands=bands, offsets=A_parts.offsets, shape=A_parts.shape,
            axis_name=A_parts.axis_name,
        )
    data = A_parts.data.at[n:, 0].set(jnp.asarray(pad_val, A_parts.data.dtype))
    return AllGatherELL(
        data=data, cols=A_parts.cols, shape=A_parts.shape,
        axis_name=A_parts.axis_name,
    )


def distributed_lobpcg(
    A,
    k: Optional[int] = None,
    X0: Optional[jax.Array] = None,
    *,
    M=None,
    largest: bool = False,
    tol: float = 1e-6,
    max_iter: int = 200,
    buffer: int = 0,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    seed: int = 0,
):
    """Compute the k smallest (or largest) eigenpairs of Hermitian ``A``,
    row-partitioned over ``mesh``.

    ``A`` may be a host CSR/DIA container (partitioned here) or an already
    partitioned :class:`AllGatherELL` / :class:`HaloDIA`.  Give either
    ``k`` (random ``X0`` built here) or an explicit global ``X0`` of shape
    (n, k).  ``M`` (optional) must be a :class:`DiagPrecond`; its diagonal
    shards with the rows.  Returns global ``(lam, X, info)`` exactly like
    :func:`~sprsolve_tpu.solvers.lobpcg.lobpcg`.
    """
    mesh = auto_mesh(mesh, axis_name)
    n_dev = mesh.shape[axis_name]

    bounds = None
    if isinstance(A, CSR):
        bounds = _gershgorin_bounds(A)
        n = A.shape[0]
        A_parts = partition_csr(A, n_dev, axis_name)
    elif isinstance(A, DIA):
        bounds = _gershgorin_bounds(A)
        n = A.shape[0]
        A_parts = partition_dia(A, n_dev, axis_name)
    elif isinstance(A, (AllGatherELL, HaloDIA)):
        A_parts = A
        n = A.shape[0]
    else:
        raise TypeError(f"cannot partition operator of type {type(A)}")
    n_pad = A_parts.shape[0]
    if bounds is not None:
        A_parts = _pad_rows(A_parts, n, largest, bounds)
    # pre-partitioned operators carry their (already padded) global shape,
    # so every row is treated as real — the contract is n divisible by the
    # mesh (identity pad rows would inject spurious unit eigenvalues)

    if X0 is None:
        if k is None:
            raise ValueError("give either k or an explicit X0")
        rng = np.random.default_rng(seed)
        X0 = rng.standard_normal((n, k))
        if np.iscomplexobj(np.asarray(A_parts.data if hasattr(A_parts, "data")
                                      else A_parts.bands)):
            X0 = X0 + 1j * rng.standard_normal((n, k))
        X0 = jnp.asarray(X0, dtype=A_parts.dtype)
    else:
        X0 = jnp.asarray(X0)
        k = X0.shape[1]
    if n_pad != n:  # pad rows start exactly zero (decoupled coordinates)
        X0 = jnp.concatenate(
            [X0, jnp.zeros((n_pad - n, k), X0.dtype)], axis=0
        )

    M_parts = None
    if M is not None:
        if not isinstance(M, DiagPrecond):
            raise TypeError("distributed_lobpcg supports DiagPrecond for M")
        di = M.diag_inv
        if di.shape[0] != n_pad:
            # pad reciprocal 1 keeps the decoupled pad coordinates inert
            di = jnp.concatenate([di, jnp.ones(n_pad - di.shape[0], di.dtype)])
        M_parts = DiagPrecond(diag_inv=di)

    a_spec = A_parts.pspec(axis_name)
    in_specs = [a_spec, P(axis_name, None)]
    if M_parts is not None:
        in_specs.append(jax.tree.map(lambda _: P(axis_name), M_parts))
    out_specs = (P(), P(axis_name, None), SolveInfo(P(), P(), P()))

    if M_parts is None:

        def run(A_, X_):
            return lobpcg(
                A_, X_, largest=largest, tol=tol, max_iter=max_iter,
                buffer=buffer, axis_name=axis_name,
            )

        args = (A_parts, X0)
    else:

        def run(A_, X_, M_):
            return lobpcg(
                A_, X_, M=M_, largest=largest, tol=tol, max_iter=max_iter,
                buffer=buffer, axis_name=axis_name,
            )

        args = (A_parts, X0, M_parts)

    sharded = jax.shard_map(
        run, mesh=mesh, in_specs=tuple(in_specs), out_specs=out_specs,
        check_vma=False,
    )
    lam, X, info = sharded(*args)
    from .multihost import replicate

    X = replicate(X, mesh)
    return lam, X[:n], info


def distributed_shift_invert_eigs(
    A,
    k: int,
    sigma: float,
    *,
    side: str = "both",
    M_inner=None,
    inner_tol: Optional[float] = None,
    inner_max_iter: int = 400,
    tol: float = 1e-6,
    max_iter: int = 100,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    seed: int = 0,
):
    """The ``k`` eigenpairs of Hermitian ``A`` nearest ``sigma``,
    row-partitioned over ``mesh``.

    The distributed composition of
    :func:`~sprsolve_tpu.solvers.eigs.shift_invert_eigs`: the μ-space LOBPCG
    block iteration runs inside one ``shard_map`` program per pass, and every
    operator application is an inner MINRES solve on the row-partitioned
    shifted operator — ``vmap``-batched over the block's columns, so the
    halo exchange and the Lanczos reductions are each ONE batched collective
    per inner iteration regardless of k.

    Padding: pad rows get diagonal σ + 2·D (D = max distance from σ to the
    Gershgorin spectrum bounds), so the pad eigenvalue is strictly FARTHER
    from σ than every true eigenvalue — its |μ| = 1/(2D) sits strictly
    inside both μ-spectrum ends and can never be selected by either LOBPCG
    pass; the inner solve stays comfortably nonsingular on the pad rows
    (|pad − σ| = 2D).  Pre-partitioned operators must be pre-padded, since
    their identity pad rows would put a spurious eigenvalue at 1 − σ.

    Returns ``(lam, X, info)`` exactly like the single-chip driver:
    eigenvalues ordered by |λ − σ|, vectors as global (n, k) columns, and
    the worst MEASURED A-residual gating CONVERGED.
    """
    from ..errors import IncompatibleMatrixFormat
    from ..ops.operator import ShiftedOperator
    from ..solvers.eigs import InvertedOperator, _select_nearest

    if k < 1:
        raise IncompatibleMatrixFormat(f"need k >= 1, got {k}")
    if side not in ("both", "above", "below"):
        raise IncompatibleMatrixFormat(
            f"side must be 'both', 'above' or 'below', got {side!r}"
        )
    if inner_tol is None:
        inner_tol = min(tol * 1e-2, 1e-8)
    mesh = auto_mesh(mesh, axis_name)
    n_dev = mesh.shape[axis_name]

    bounds = None
    if isinstance(A, CSR):
        bounds = _gershgorin_bounds(A)
        n = A.shape[0]
        A_parts = partition_csr(A, n_dev, axis_name)
    elif isinstance(A, DIA):
        bounds = _gershgorin_bounds(A)
        n = A.shape[0]
        A_parts = partition_dia(A, n_dev, axis_name)
    elif isinstance(A, (AllGatherELL, HaloDIA)):
        A_parts = A
        n = A.shape[0]
    else:
        raise TypeError(f"cannot partition operator of type {type(A)}")
    n_pad = A_parts.shape[0]
    if bounds is not None:
        lo, hi = bounds
        D = max(abs(hi - sigma), abs(lo - sigma), 1.0)
        A_parts = _set_pad_diag(A_parts, n, sigma + 2.0 * D)
    # pre-partitioned operators carry their (already padded) global shape,
    # so every row is treated as real — the contract is n divisible by the
    # mesh (identity pad rows would put a spurious eigenvalue at 1, often
    # near σ)

    dt = A_parts.dtype
    shifted = ShiftedOperator(A=A_parts, shift=jnp.asarray(sigma, dt))

    M_parts = None
    if M_inner is not None:
        if not isinstance(M_inner, DiagPrecond):
            raise TypeError(
                "distributed_shift_invert_eigs supports DiagPrecond for "
                "M_inner"
            )
        di = M_inner.diag_inv
        if di.shape[0] != n_pad:
            di = jnp.concatenate([di, jnp.ones(n_pad - di.shape[0], di.dtype)])
        M_parts = DiagPrecond(diag_inv=di)

    inv = InvertedOperator(
        A=shifted, M=M_parts,
        inner_tol=float(inner_tol), inner_max_iter=int(inner_max_iter),
        axis_name=axis_name,
    )

    rng = np.random.default_rng(seed)
    X0 = rng.standard_normal((n, k))
    if jnp.iscomplexobj(jnp.zeros((), dt)):
        X0 = X0 + 1j * rng.standard_normal((n, k))
    X0 = jnp.asarray(
        np.concatenate([X0, np.zeros((n_pad - n, k))], axis=0), dt
    )

    a_spec = A_parts.pspec(axis_name)
    inv_spec = InvertedOperator(
        A=ShiftedOperator(A=a_spec, shift=P()),
        M=(None if M_parts is None
           else jax.tree.map(lambda _: P(axis_name), M_parts)),
        inner_tol=float(inner_tol), inner_max_iter=int(inner_max_iter),
        axis_name=axis_name,
    )
    in_specs = (inv_spec, P(axis_name, None))
    out_specs = (P(), P(axis_name, None), SolveInfo(P(), P(), P()))

    from .multihost import replicate

    passes = {"both": (True, False), "above": (True,), "below": (False,)}[side]
    cand, total_its = [], 0
    for largest in passes:
        # μ-space margin: same tol/10 overshoot as the single-chip driver
        # (the CONVERGED gate below is the measured A-residual, strict)
        def run(inv_, X_, _largest=largest):
            return lobpcg(
                inv_, X_, largest=_largest, tol=tol / 10, max_iter=max_iter,
                axis_name=axis_name,
            )

        sharded = jax.shard_map(
            run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
        _, Xp, info_p = sharded(inv, X0)
        total_its += int(info_p.iterations)
        cand.append(np.asarray(replicate(Xp, mesh)))

    # merge: truncate the pad rows, drop pad-dominated columns (a true
    # eigenvector has exactly-zero pad coordinates, so its truncated norm is
    # 1; a pad eigenvector truncates to ~0), then Rayleigh quotients and
    # residuals on the ORIGINAL rows via the distributed operator (the pad
    # rows are decoupled, so zero-padded columns see exactly A)
    Xall = np.concatenate(cand, axis=1)[:n]
    norms = np.linalg.norm(Xall, axis=0)
    keep = norms > 0.5
    Xall = Xall[:, keep] / norms[keep]
    Xp_full = jnp.asarray(
        np.concatenate([Xall, np.zeros((n_pad - n, Xall.shape[1]))], axis=0),
        dt,
    )
    AX = jax.shard_map(
        lambda A_, X_: A_.matmat(X_),
        mesh=mesh, in_specs=(a_spec, P(axis_name, None)),
        out_specs=P(axis_name, None), check_vma=False,
    )(A_parts, Xp_full)
    AXn = np.asarray(replicate(AX, mesh))[:n]
    lam_all = np.real(np.sum(np.conj(Xall) * AXn, axis=0))
    R = AXn - Xall * lam_all[None, :].astype(Xall.dtype)
    rel_all = np.linalg.norm(R, axis=0) / np.maximum(
        np.abs(lam_all), np.finfo(lam_all.dtype).tiny
    )
    return _select_nearest(
        lam_all, rel_all, Xall, sigma, side, k, tol, total_its
    )


def distributed_rational_filter_eigs(
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
    inner_refine: int = 0,
    tol: float = 1e-6,
    max_iter: int = 8,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    seed: int = 0,
):
    """The ``k`` eigenpairs of real-symmetric ``A`` nearest ``sigma``,
    row-partitioned over ``mesh`` — the distributed composition of
    :func:`~sprsolve_tpu.solvers.rational.rational_filter_eigs`.

    Per subspace iteration (one ``shard_map`` program): each quadrature
    node's complex-shifted system runs as a ``vmap``-batched COCG over the
    m0 columns — the halo exchange and the COCG reductions are each ONE
    batched collective per inner iteration regardless of m0 (the complex
    matvec decomposes onto two REAL halo applications of the partitioned
    operator); the tall-skinny orthonormalization is CholQR2 (Gram psum +
    replicated Cholesky, twice — no gather); the m0×m0 Rayleigh–Ritz
    problem is solved redundantly per device from replicated inputs.

    Padding: pad rows get diagonal σ + 2·D (outside every disc the
    calibration can reach), start at exactly zero in Y0, and stay zero
    through filter/QR (the padded rows are decoupled and their rhs is
    zero), so the Ritz spectrum on the real rows is exact.  The host-side
    radius calibration loop and ghost-filtered selection are shared with
    the single-chip driver.
    """
    from ..errors import IncompatibleMatrixFormat
    from ..solvers.cocg import cocg
    from ..solvers.eigs import _select_nearest
    from ..solvers.rational import _ComplexShifted, _gauss_semicircle

    if k < 1:
        raise IncompatibleMatrixFormat(f"need k >= 1, got {k}")
    if side not in ("both", "above", "below"):
        raise IncompatibleMatrixFormat(
            f"side must be 'both', 'above' or 'below', got {side!r}"
        )
    if m0 is None:
        m0 = max(2 * k, k + 6)
    if inner_tol is None:
        inner_tol = min(tol * 1e-2, 1e-7)
    mesh = auto_mesh(mesh, axis_name)
    n_dev = mesh.shape[axis_name]

    if isinstance(A, CSR):
        bounds = _gershgorin_bounds(A)
        n = A.shape[0]
        A_parts = partition_csr(A, n_dev, axis_name)
    elif isinstance(A, DIA):
        bounds = _gershgorin_bounds(A)
        n = A.shape[0]
        A_parts = partition_dia(A, n_dev, axis_name)
    else:
        raise TypeError(
            "distributed_rational_filter_eigs needs a host CSR/DIA "
            f"container, got {type(A)}"
        )
    n_pad = A_parts.shape[0]
    lo, hi = bounds
    D = max(abs(hi - sigma), abs(lo - sigma), 1.0)
    A_parts = _set_pad_diag(A_parts, n, sigma + 2.0 * D)

    rdt = jnp.dtype(A_parts.dtype)
    if rdt not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
        raise IncompatibleMatrixFormat(
            "rational filter needs a real symmetric operator "
            f"(dtype {rdt}); use distributed_shift_invert_eigs for complex"
        )
    cdt = jnp.complex64 if rdt == jnp.dtype(jnp.float32) else jnp.complex128

    # mixed-precision inner refinement (same scheme as the single-device
    # driver, solvers/rational.py): a partitioned f64 copy serves the
    # straight-line true-residual corrections and the f64 quadrature
    # accumulation — no f64 control flow
    A64_parts = None
    if inner_refine:
        if not jax.config.jax_enable_x64:
            raise IncompatibleMatrixFormat(
                "inner_refine needs jax_enable_x64 (f64 true residuals)"
            )
        import dataclasses as _dc

        if isinstance(A, CSR):
            src64 = _dc.replace(
                A, data=jnp.asarray(np.asarray(A.data), jnp.float64)
            )
            A64_parts = partition_csr(src64, n_dev, axis_name)
        else:
            src64 = _dc.replace(
                A, bands=jnp.asarray(np.asarray(A.bands), jnp.float64)
            )
            A64_parts = partition_dia(src64, n_dev, axis_name)
        A64_parts = _set_pad_diag(A64_parts, n, sigma + 2.0 * D)

    c_np, d_np = _gauss_semicircle(int(n_quad), float(contour_aspect))
    _hp = jax.lax.Precision.HIGHEST

    rng = np.random.default_rng(seed)
    Y0 = jnp.asarray(
        np.concatenate(
            [rng.standard_normal((n, m0)), np.zeros((n_pad - n, m0))], axis=0
        ), rdt,
    )

    def step(A_, A64_, Y, r):
        """One filter + Rayleigh–Ritz pass; runs INSIDE shard_map."""
        Yc = Y.astype(cdt)
        its = jnp.int32(0)

        def solve_node(zr, zi, rhs):
            opz = _ComplexShifted(A=A_, zr=zr, zi=zi)
            solve_col = lambda y, o=opz: cocg(
                o, y, tol=inner_tol, max_iter=inner_max_iter,
                axis_name=axis_name,
            )
            X, infos = jax.vmap(solve_col, in_axes=1, out_axes=(1, 0))(rhs)
            return X, jnp.sum(infos.iterations).astype(jnp.int32)

        if inner_refine:
            # f64-plane refinement + f64 quadrature accumulation (the
            # per-node resolvents are near-singular-sized; their
            # cross-node cancellation must happen in f64 — see
            # solvers/rational.py for the measured failure mode)
            cr = jnp.float32 if cdt == jnp.complex64 else jnp.float64
            Q64 = jnp.zeros(Y.shape, jnp.float64)
            r64 = r.astype(jnp.float64)
            Yr64 = jnp.real(Yc).astype(jnp.float64)
            Yi64 = jnp.imag(Yc).astype(jnp.float64)
            for j in range(int(n_quad)):
                zr = sigma + r * jnp.asarray(c_np[j].real, rdt)
                zi = r * jnp.asarray(c_np[j].imag, rdt)
                zr64 = zr.astype(jnp.float64)
                zi64 = zi.astype(jnp.float64)
                X, itj = solve_node(zr, zi, Yc)
                its = its + itj
                Xr = jnp.real(X).astype(jnp.float64)
                Xi = jnp.imag(X).astype(jnp.float64)
                for _ in range(int(inner_refine)):
                    AXr = A64_.matmat(Xr)
                    AXi = A64_.matmat(Xi)
                    Rr = Yr64 - (zr64 * Xr - zi64 * Xi - AXr)
                    Ri = Yi64 - (zr64 * Xi + zi64 * Xr - AXi)
                    Dx, itd = solve_node(
                        zr, zi, Rr.astype(cr) + 1j * Ri.astype(cr)
                    )
                    Xr = Xr + jnp.real(Dx).astype(jnp.float64)
                    Xi = Xi + jnp.imag(Dx).astype(jnp.float64)
                    its = its + itd
                Q64 = Q64 + r64 * (
                    float(d_np[j].real) * Xr - float(d_np[j].imag) * Xi
                )
            Q = Q64.astype(rdt)
        else:
            Q = jnp.zeros_like(Y)
            for j in range(int(n_quad)):
                zr = sigma + r * jnp.asarray(c_np[j].real, rdt)
                zi = r * jnp.asarray(c_np[j].imag, rdt)
                Xj, itj = solve_node(zr, zi, Yc)
                Q = Q + r * jnp.real(jnp.asarray(d_np[j], cdt) * Xj)
                its = its + itj
        est = jax.lax.psum(jnp.sum(Y * Q), axis_name) / Y.shape[1]

        # CholQR2: Gram-psum + replicated Cholesky, twice (row-sharded
        # tall-skinny QR without a gather; same scheme as distributed
        # LOBPCG's basis refresh)
        def cholqr(B):
            G = jax.lax.psum(
                jnp.matmul(B.T, B, precision=_hp), axis_name
            )
            # tiny ridge keeps the factor well-posed when the filter
            # annihilates directions (noise fills them next pass)
            eps_r = jnp.asarray(
                np.finfo(np.dtype(rdt)).eps * 100, rdt
            ) * jnp.trace(G)
            L = jnp.linalg.cholesky(
                G + eps_r * jnp.eye(G.shape[0], dtype=rdt)
            )
            return jax.scipy.linalg.solve_triangular(
                L, B.T, lower=True
            ).T

        Qo = cholqr(cholqr(Q))
        AQ = A_.matmat(Qo)
        H = jax.lax.psum(jnp.matmul(Qo.T, AQ, precision=_hp), axis_name)
        H = 0.5 * (H + H.T)
        lam, W = jnp.linalg.eigh(H)
        V = jnp.matmul(Qo, W, precision=_hp)
        AV = jnp.matmul(AQ, W, precision=_hp)
        R = AV - V * lam[None, :]
        rel = jnp.sqrt(
            jax.lax.psum(jnp.sum(R * R, axis=0), axis_name)
        ) / jnp.maximum(jnp.abs(lam), jnp.finfo(rdt).tiny)
        return V, lam, rel, its, est

    a_spec = A_parts.pspec(axis_name)
    a64_spec = (
        None if A64_parts is None else A64_parts.pspec(axis_name)
    )
    sharded_step = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(a_spec, a64_spec, P(axis_name, None), P()),
        out_specs=(P(axis_name, None), P(), P(), P(), P()),
        check_vma=False,
    ))

    if radius is not None:
        r_cur = float(radius)
        calibrate = False
    else:
        r_cur = max((hi - lo) * 1e-3, 1e-12)
        calibrate = True

    from .multihost import replicate

    total_inner = 0
    best = None
    Y = Y0
    y_is_random = True
    target = k + max(1.0, (m0 - k) / 3.0)
    calib_left = 6
    for _ in range(int(max_iter)):
        V, lam, rel, its, est = sharded_step(
            A_parts, A64_parts, Y, jnp.asarray(r_cur, rdt)
        )
        total_inner += int(its)
        lam_np = np.asarray(lam)
        rel_np = np.asarray(rel)
        inside = np.abs(lam_np - sigma) <= r_cur
        if side == "above":
            inside &= lam_np >= sigma
        elif side == "below":
            inside &= lam_np < sigma
        n_in = int(inside.sum())
        best = (lam_np, rel_np, V)
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
            count = float(n_in)
            if y_is_random:
                count = max(count, float(est))
            count = max(count, 0.5)
            r_cur *= float(np.clip(target / count, 0.05, 20.0))
            Y = Y0
            y_is_random = True
            continue
        Y = V
        y_is_random = False

    lam_np, rel_np, V = best
    Vnp = np.asarray(replicate(V, mesh))[:n]
    order_keep = (np.abs(lam_np - sigma) <= r_cur) & (
        rel_np <= max(10.0 * tol, float(np.sqrt(np.finfo(rdt).eps)))
    )
    return _select_nearest(
        lam_np[order_keep], rel_np[order_keep], Vnp[:, order_keep],
        sigma, side, k, tol, total_inner,
    )
