"""Preconditioners.

``DiagPrecond`` mirrors the reference (``src/precond.rs``): the reciprocal of
the diagonal is taken once at construction (``src/precond.rs:20-30``) and the
apply is an elementwise multiply (``src/precond.rs:48-52``).  As in the
reference, the diagonal may be *real* while the system is complex
(``src/precond.rs:6-13``, exercised by ``tests/test_complex_solve.rs:44``) —
jnp broadcasting provides the mixed-dtype multiply.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class DiagPrecond:
    """Jacobi (diagonal) preconditioner: M⁻¹ = diag(1/d)."""

    diag_inv: jax.Array

    @staticmethod
    def new(diag) -> "DiagPrecond":
        diag = jnp.asarray(diag)
        return DiagPrecond(diag_inv=jnp.ones((), diag.dtype) / diag)

    @property
    def shape(self):
        n = self.diag_inv.shape[0]
        return (n, n)

    def matvec(self, x: jax.Array) -> jax.Array:
        return x * self.diag_inv

    def matvec_dot(self, x: jax.Array):
        # The reference leaves this unimplemented! (src/precond.rs:55-62);
        # here the fused form is free, so provide it.
        from .vecalg import conj_dot

        y = x * self.diag_inv
        return y, conj_dot(x, y)


jax.tree_util.register_dataclass(DiagPrecond, data_fields=("diag_inv",), meta_fields=())


@dataclasses.dataclass(frozen=True)
class ComplexDiagPrecond:
    """Jacobi preconditioner with a *complex* diagonal, stored as re/im planes.

    The complex multiply is formed in the apply.  Semantics match ``DiagPrecond`` with ``1/d`` complex
    (reference ``src/precond.rs:20-30`` with ``V = Complex``).
    """

    inv_re: jax.Array
    inv_im: jax.Array

    @staticmethod
    def new(diag) -> "ComplexDiagPrecond":
        import numpy as np

        d = np.asarray(diag)
        inv = np.ones((), d.dtype) / d
        rdt = inv.real.dtype
        return ComplexDiagPrecond(
            inv_re=jnp.asarray(inv.real.astype(rdt)),
            inv_im=jnp.asarray(inv.imag.astype(rdt)),
        )

    @property
    def shape(self):
        n = self.inv_re.shape[0]
        return (n, n)

    def matvec(self, x: jax.Array) -> jax.Array:
        return x * (self.inv_re + 1j * self.inv_im).astype(x.dtype)

    def matvec_dot(self, x: jax.Array):
        from .vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)


jax.tree_util.register_dataclass(
    ComplexDiagPrecond, data_fields=("inv_re", "inv_im"), meta_fields=()
)


@dataclasses.dataclass(frozen=True)
class ChebyshevPrecond:
    """Chebyshev polynomial preconditioner: M⁻¹ ≈ p_k(A) ≈ A⁻¹ on [λmin, λmax].

    The most data-parallel preconditioner beyond Jacobi: the apply is k
    SpMVs and axpys with *no* sequential row dependencies or triangular
    solves — it runs at SpMV speed through any operator and distributes for
    free.  Requires SPD-ish A with a known (or
    estimated) spectrum interval; classical three-term recurrence.

    Beyond the reference's feature set (it only ships DiagPrecond) — included
    because polynomial preconditioning is the idiomatic accelerator answer to
    the triangular-solve preconditioners that serialize on parallel
    hardware.
    """

    A: object          # LinearOperator
    lmin: float        # spectrum lower bound (meta: static)
    lmax: float        # spectrum upper bound
    degree: int = 4

    @property
    def shape(self):
        return self.A.shape

    @staticmethod
    def estimate_lmax(A, x_example, iters: int = 20) -> float:
        """Power-iteration estimate of the largest |eigenvalue| (host-side)."""
        import numpy as np

        x = x_example
        if float(jnp.linalg.norm(x.ravel())) == 0.0:
            x = jnp.ones_like(x_example)
        lam = 1.0
        for _ in range(iters):
            y = A.matvec(x)
            lam = float(jnp.linalg.norm(y.ravel()))
            x = y / lam
        return lam

    @classmethod
    def auto(cls, A, x_example=None, *, degree: int = 4, lanczos_iters: int = 30,
             seed: int = 0) -> "ChebyshevPrecond":
        """Build with spectral bounds estimated by :func:`estimate_spectral_bounds`.

        ``A`` must be SPD/HPD (positive estimated spectrum) — raises
        :class:`~sprsolve_tpu.errors.InvalidPreconditioner` otherwise.
        """
        from .errors import InvalidPreconditioner

        lmin, lmax = estimate_spectral_bounds(
            A, x_example, m=lanczos_iters, seed=seed
        )
        if lmin <= 0.0:
            raise InvalidPreconditioner(
                f"Chebyshev needs a positive spectrum; estimated "
                f"[{lmin:.3g}, {lmax:.3g}] — is A SPD?"
            )
        return cls(A=A, lmin=lmin, lmax=lmax, degree=degree)

    def matvec(self, r: jax.Array) -> jax.Array:
        # Chebyshev iteration for A z = r from z0 = 0 (Saad, Iterative
        # Methods, alg. 12.1): theta = (λmax+λmin)/2, delta = (λmax−λmin)/2.
        theta = (self.lmax + self.lmin) / 2.0
        delta = (self.lmax - self.lmin) / 2.0
        dt = jnp.asarray(theta, r.dtype)
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        z = r / dt
        d = z
        res = r - self.A.matvec(z)
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = res * jnp.asarray(2.0 * rho_new / delta, r.dtype) + d * jnp.asarray(
                rho_new * rho, r.dtype
            )
            z = z + d
            res = r - self.A.matvec(z)
            rho = rho_new
        return z

    def matvec_dot(self, r: jax.Array):
        from .vecalg import conj_dot

        z = self.matvec(r)
        return z, conj_dot(r, z)


jax.tree_util.register_dataclass(
    ChebyshevPrecond, data_fields=("A",), meta_fields=("lmin", "lmax", "degree")
)


def estimate_spectral_bounds(A, x_example=None, *, m: int = 30, seed: int = 0,
                             safety: float = 0.05):
    """Estimate the extreme eigenvalues of a Hermitian operator.

    ``m``-step Lanczos with full reorthogonalization, run host-side against
    the (jitted) ``A.matvec`` — a one-time setup cost, like the reference's
    ``mkl_sparse_optimize`` hint pass.  Returns ``(lmin, lmax)`` widened by
    ``safety`` on each end (Ritz values under-estimate the true extremes, and
    Chebyshev bounds must *bracket* the spectrum to contract).

    ``x_example`` fixes the start-vector shape/dtype for operators with an
    internal layout (``Reordered``: pass ``op.pad_vec(v)``); by default a
    seeded unit-normal flat vector of size ``A.shape[0]`` is used.
    """
    import numpy as np

    if x_example is None:
        n = A.shape[0]
        dt = getattr(A, "dtype", None) or jnp.float32
        rdt0 = jnp.finfo(dt).dtype if not jnp.issubdtype(dt, jnp.complexfloating) \
            else jnp.real(jnp.zeros((), dt)).dtype
        x = jnp.asarray(
            np.random.default_rng(seed).standard_normal(n), rdt0
        ).astype(dt)
    else:
        x = jnp.asarray(x_example)
    mv = jax.jit(A.matvec)
    nrm = float(jnp.linalg.norm(x.ravel()))
    q = x / x.dtype.type(nrm)
    basis = [q]
    alphas: list[float] = []
    betas: list[float] = []
    beta = 0.0
    q_prev = jnp.zeros_like(q)
    for _ in range(m):
        w = mv(q)
        alpha = float(jnp.vdot(q.ravel(), w.ravel()).real)
        w = w - q.dtype.type(alpha) * q - q.dtype.type(beta) * q_prev
        for qq in basis:  # full reorthogonalization (small m, host-driven)
            w = w - jnp.vdot(qq.ravel(), w.ravel()) * qq
        alphas.append(alpha)
        beta = float(jnp.linalg.norm(w.ravel()))
        if not np.isfinite(beta) or beta < 1e-30:
            break
        betas.append(beta)
        q_prev, q = q, w / w.dtype.type(beta)
        basis.append(q)
    T = np.diag(np.asarray(alphas, np.float64))
    if len(alphas) > 1:
        off = np.asarray(betas[: len(alphas) - 1], np.float64)
        T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    lmin, lmax = float(ev[0]), float(ev[-1])
    lmin = lmin * (1.0 - safety) if lmin > 0 else lmin * (1.0 + safety)
    lmax = lmax * (1.0 + safety) if lmax > 0 else lmax * (1.0 - safety)
    return lmin, lmax


@dataclasses.dataclass(frozen=True)
class BlockJacobiPrecond:
    """Block-Jacobi preconditioner: M⁻¹ = blockdiag(A₁₁⁻¹, …, A_kk⁻¹).

    The dense-block generalization of :class:`DiagPrecond` (reference
    ``src/precond.rs`` stores ``1/diag``; here each dense ``bs×bs`` diagonal
    block is inverted once on the host).  The apply is a single batched
    ``(nb, bs, bs) × (nb, bs)`` contraction — exactly the regular, large,
    batched matmul shape accelerators run well, with no sequential row
    dependencies — so it runs at full speed through jit/vmap/shard_map.

    If A is SPD/Hermitian every diagonal block is too, hence M⁻¹ is HPD and
    valid for CG and for MINRES's β² = rᴴM⁻¹r > 0 gate
    (``src/minres.rs:235-244``).
    """

    inv_blocks: jax.Array  # (nb, bs, bs)
    n: int                 # original dimension (meta: static)

    @property
    def shape(self):
        return (self.n, self.n)

    @staticmethod
    def from_csr(A, *, block_size: int = 16) -> "BlockJacobiPrecond":
        import numpy as np

        from .errors import InvalidPreconditioner

        n = A.shape[0]
        bs = int(block_size)
        nb = -(-n // bs)
        indptr = np.asarray(A.indptr, np.int64)
        indices = np.asarray(A.indices, np.int64)
        data = np.asarray(A.data)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        in_block = (rows // bs) == (indices // bs)
        r, c, v = rows[in_block], indices[in_block], data[in_block]
        blocks = np.zeros((nb, bs, bs), dtype=data.dtype)
        # np.add.at sums duplicate (row, col) entries, consistent with
        # CSR.diagonal() (fancy-index assignment would keep only the last)
        np.add.at(blocks, (r // bs, r % bs, c % bs), v)
        pad = np.arange(n, nb * bs)  # unit diagonal keeps padded lanes inert
        blocks[pad // bs, pad % bs, pad % bs] = 1
        wide = blocks.astype(
            np.complex128 if np.iscomplexobj(data) else np.float64
        )
        try:
            inv = np.linalg.inv(wide)
        except np.linalg.LinAlgError:
            raise InvalidPreconditioner(
                "block-Jacobi: a diagonal block is singular"
            ) from None
        return BlockJacobiPrecond(
            inv_blocks=jnp.asarray(inv.astype(data.dtype)), n=n
        )

    def matvec(self, r: jax.Array) -> jax.Array:
        nb, bs, _ = self.inv_blocks.shape
        rp = jnp.pad(r, (0, nb * bs - self.n)).reshape(nb, bs)
        z = jnp.einsum(
            "bij,bj->bi", self.inv_blocks, rp,
            precision=jax.lax.Precision.HIGHEST,
        )
        return z.reshape(-1)[: self.n]

    def matvec_dot(self, x: jax.Array):
        from .vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)


jax.tree_util.register_dataclass(
    BlockJacobiPrecond, data_fields=("inv_blocks",), meta_fields=("n",)
)


def _split_factored(n, indptr, indices, factored):
    """Host-side split of a merged factor values array into CSR triplets:
    (strict-lower, strict-upper, diagonal).  The diagonal positions hold
    diag(U) after ilu0 and diag(L) after ic0; ic0 leaves the strict-upper
    positions untouched, so its caller ignores the ``up`` triplet."""
    import numpy as np

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    lo = cols < rows
    up = cols > rows
    dg = cols == rows
    diag = np.zeros(n, dtype=factored.dtype)
    diag[rows[dg]] = factored[dg]

    def csr_of(mask):
        ip = np.zeros(n + 1, dtype=np.int64)
        np.add.at(ip, rows[mask] + 1, 1)
        np.cumsum(ip, out=ip)
        return ip, indices[mask].astype(np.int32), factored[mask]

    return csr_of(lo), csr_of(up), diag


def _operator_of(n, trip, dtype, layout_kwargs):
    """Build a device operator for one triangular part, or None if empty."""
    import numpy as np

    from .ops.optimize import optimize
    from .sparse.containers import CSR

    ip, ind, val = trip
    if len(val) == 0:
        return None
    csr = CSR.from_arrays(
        jnp.asarray(val.astype(dtype, copy=False)),
        jnp.asarray(ind),
        jnp.asarray(ip),
        (n, n),
    )
    return optimize(csr, **layout_kwargs)


def _sweep_lower(L_s, r, y0, sweeps):
    """Truncated-Neumann solve of (I + L_s)·y = r: y ← r − L_s·y."""
    y = y0
    if L_s is None:
        return r
    for _ in range(sweeps):
        y = r - L_s.matvec(y)
    return y


def _sweep_scaled(N_s, d_inv, r, z0, sweeps):
    """Truncated-Jacobi solve of (D + N_s)·z = r: z ← D⁻¹(r − N_s·z)."""
    z = z0
    if N_s is None:
        return r * d_inv
    for _ in range(sweeps):
        z = (r - N_s.matvec(z)) * d_inv
    return z


@dataclasses.dataclass(frozen=True)
class ILU0Precond:
    """ILU(0) preconditioner with iterative (Jacobi-sweep) triangular solves.

    The factorization A ≈ L·U (zero fill-in, ``native.ilu0`` — the analog of
    what MKL-era CPU codes pair with the reference's solvers; the reference
    itself ships only ``DiagPrecond``, ``src/precond.rs``) runs once on the
    host.  The *apply* replaces the inherently sequential triangular solves
    with ``sweeps`` truncated-Neumann iterations — each sweep is one SpMV
    with a strict-triangular factor, so the apply is stencil-kernel-shaped
    and distributes/jits like any operator (the standard accelerator
    formulation, cf. Chow & Patel, "Fine-grained parallel ILU").  With
    ``sweeps ≥ the factor's level depth`` the solve is exact; small sweep
    counts give a weaker but still effective preconditioner.

    Not symmetric — use with BiCGStab (the reference pairs its
    preconditioner with BiCGStab the same way, ``src/bicg_stab.rs:204``).
    For MINRES use :class:`IC0Precond`, whose apply is SPD by construction.
    """

    L_s: object        # strict lower of L (unit diag implied), or None
    U_s: object        # strict upper of U, or None
    du_inv: jax.Array  # 1 / diag(U)
    sweeps: int = 3

    @property
    def shape(self):
        n = self.du_inv.shape[0]
        return (n, n)

    @staticmethod
    def from_csr(A, *, sweeps: int = 3, **layout_kwargs):
        """Factor a host-side CSR and build the apply operators.

        ``layout_kwargs`` are forwarded to :func:`~sprsolve_tpu.ops.optimize`
        for the triangular parts.
        """
        import numpy as np

        from .errors import ZeroDiagonalElem
        from . import native

        n = A.shape[0]
        indptr = np.asarray(A.indptr, np.int64)
        indices = np.asarray(A.indices, np.int32)
        values = np.asarray(A.data)
        try:
            factored = native.ilu0(n, indptr, indices, values)
        except ZeroDivisionError as e:
            raise ZeroDiagonalElem(
                f"ILU(0): zero pivot at row {e.args[0]}"
            ) from None
        lo, up, diag = _split_factored(n, indptr, indices, factored)
        dtype = values.dtype
        return ILU0Precond(
            L_s=_operator_of(n, lo, dtype, layout_kwargs),
            U_s=_operator_of(n, up, dtype, layout_kwargs),
            du_inv=jnp.asarray(np.ones((), dtype) / diag),
            sweeps=sweeps,
        )

    def matvec(self, r: jax.Array) -> jax.Array:
        # L·y = r (unit lower) then U·z = y (upper with diagonal du)
        y = _sweep_lower(self.L_s, r, r, self.sweeps)
        return _sweep_scaled(self.U_s, self.du_inv, y, y * self.du_inv, self.sweeps)

    def matvec_dot(self, x: jax.Array):
        from .vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)


jax.tree_util.register_dataclass(
    ILU0Precond, data_fields=("L_s", "U_s", "du_inv"), meta_fields=("sweeps",)
)


@dataclasses.dataclass(frozen=True)
class IC0Precond:
    """IC(0) (incomplete Cholesky) preconditioner, SPD apply, for MINRES.

    A ≈ L·Lᴴ factored on the host (``native.ic0``); the apply approximates
    z = L⁻ᴴ L⁻¹ r with ``sweeps`` truncated-Jacobi iterations per
    triangular solve.  Writing the approximate L-solve as the polynomial
    operator S = Σ_{j≤sweeps} (−D⁻¹L_s)ʲ D⁻¹, the approximate Lᴴ-solve with
    the same sweep count is exactly Sᴴ, so the composed apply M̃⁻¹ = Sᴴ·S is
    Hermitian positive definite for any sweep count — it passes MINRES's
    β² = rᴴM⁻¹r > 0 gate (``src/minres.rs:235-244``) by construction.
    """

    L_s: object         # strict lower of L, or None
    LH_s: object        # its conjugate transpose (strict upper), or None
    dl_inv: jax.Array   # 1 / diag(L)  (real positive)
    sweeps: int = 3

    @property
    def shape(self):
        n = self.dl_inv.shape[0]
        return (n, n)

    @staticmethod
    def from_csr(A, *, sweeps: int = 3, **layout_kwargs):
        import numpy as np

        from .errors import InvalidPreconditioner
        from . import native

        n = A.shape[0]
        indptr = np.asarray(A.indptr, np.int64)
        indices = np.asarray(A.indices, np.int32)
        values = np.asarray(A.data)
        try:
            factored = native.ic0(n, indptr, indices, values)
        except ZeroDivisionError as e:
            raise InvalidPreconditioner(
                f"IC(0): non-positive pivot at row {e.args[0]} "
                "(matrix not SPD on this pattern)"
            ) from None
        lo, _, diag = _split_factored(n, indptr, indices, factored)
        # build Lᴴ strict part host-side: transpose of the strict-lower CSR
        ip, ind, val = lo
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        tr_rows, tr_cols, tr_vals = ind.astype(np.int64), rows, np.conj(val)
        tro = np.lexsort((tr_cols, tr_rows))
        tip = np.zeros(n + 1, dtype=np.int64)
        np.add.at(tip, tr_rows[tro] + 1, 1)
        np.cumsum(tip, out=tip)
        up = (tip, tr_cols[tro].astype(np.int32), tr_vals[tro])
        dtype = values.dtype
        rdt = np.real(diag).dtype
        return IC0Precond(
            L_s=_operator_of(n, lo, dtype, layout_kwargs),
            LH_s=_operator_of(n, up, dtype, layout_kwargs),
            dl_inv=jnp.asarray(np.ones((), rdt) / np.real(diag).astype(rdt)),
            sweeps=sweeps,
        )

    def matvec(self, r: jax.Array) -> jax.Array:
        y = _sweep_scaled(self.L_s, self.dl_inv, r, r * self.dl_inv, self.sweeps)
        return _sweep_scaled(self.LH_s, self.dl_inv, y, y * self.dl_inv, self.sweeps)

    def matvec_dot(self, x: jax.Array):
        from .vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)


jax.tree_util.register_dataclass(
    IC0Precond, data_fields=("L_s", "LH_s", "dl_inv"), meta_fields=("sweeps",)
)


@dataclasses.dataclass(frozen=True)
class RelayedPrecond:
    """Adapts a flat-layout preconditioner to an operator's own layout.

    Operators exposing ``pad_vec``/``unpad_vec`` (``Reordered``) run their
    solves in an internal (permuted) layout; a preconditioner built in the
    natural (n,) layout is applied by round-tripping through that layout.
    ``DiagPrecond`` has a faster dedicated path (``relay_diag_precond``, a
    one-time diagonal re-lay); this wrapper serves every other
    preconditioner type.
    """

    inner: object
    op: object

    @property
    def shape(self):
        return self.inner.shape

    def matvec(self, r2: jax.Array) -> jax.Array:
        return self.op.pad_vec(self.inner.matvec(self.op.unpad_vec(r2)))

    def matvec_dot(self, r2: jax.Array):
        from .vecalg import conj_dot

        y = self.matvec(r2)
        return y, conj_dot(r2, y)


jax.tree_util.register_dataclass(
    RelayedPrecond, data_fields=("inner", "op"), meta_fields=()
)


def real_abs_jacobi(op) -> "DiagPrecond":
    """Real 1/|d| Jacobi in ``op``'s own layout — the valid preconditioner
    shape for the Saunders process of preconditioned CS-MINRES (real
    symmetric positive; Freund's standard choice for complex-symmetric
    systems).  One dispatcher for every operator class (Reordered wrappers
    recurse into the permuted inner operator; CSR-planes fallbacks build
    from the plane CSR diagonals; anything else from ``diagonal()``).  Zero
    diagonals are forced to 1 (inert)."""
    import numpy as np

    # Reordered wrapper: solves run in permuted layout — build from the
    # inner operator so the diagonal lands in solve space
    if hasattr(op, "inner") and hasattr(op, "perm"):
        return real_abs_jacobi(op.inner)
    if hasattr(op, "re") and hasattr(op.re, "diagonal"):
        # CSR-planes fallback operator (_PlanesComplexOp and kin)
        dr = np.asarray(op.re.diagonal())
        di = np.asarray(op.im.diagonal())
        d = np.hypot(dr, di)
        d[d == 0] = 1.0
        return DiagPrecond.new(d.astype(dr.dtype))
    d = np.abs(np.asarray(op.diagonal()))
    d[d == 0] = 1.0
    rdt = d.dtype if d.dtype in (np.float32, np.float64) else np.float32
    return DiagPrecond.new(d.astype(rdt))


@dataclasses.dataclass(frozen=True)
class InnerSolvePrecond:
    """Preconditioner that applies a budgeted INNER Krylov solve: z ≈ A⁻¹·r.

    The inner-outer pattern (Saad, *Iterative Methods* §9.4): a few CG /
    BiCGStab / Chebyshev-free iterations make a far stronger preconditioner
    than one Jacobi/ILU apply, but the resulting map r ↦ z is a *nonlinear*
    function of r (Krylov polynomials depend on the input), so the outer
    solver must be flexible — use :func:`sprsolve_tpu.solvers.fgmres`, which
    keeps the per-step preconditioned basis instead of assuming a fixed M.
    Plain right-preconditioned GMRES with this M silently reconstructs the
    update with the WRONG operator (tested divergence in
    ``tests/test_fgmres.py``).

    The inner solve starts from z₀ = 0 each apply, runs at most ``iters``
    steps (``inner_tol`` allows early exit — the variability is what FGMRES
    exists to absorb), ignores its convergence status, and compiles into the
    outer ``lax.while_loop`` body as a nested loop — no host round-trips.
    ``A`` should be the SAME (possibly layout-padded) operator the outer
    solve runs on, so vector layouts agree; ``inner_M`` optionally
    preconditions the inner solve itself (e.g. Jacobi-in-CG-in-FGMRES).
    """

    A: object
    inner_M: object = None
    method: str = "cg"
    iters: int = 8
    inner_tol: float = 0.0
    axis_name: object = None

    @property
    def shape(self):
        return getattr(self.A, "shape", None)

    # inner methods with the standard (A, b, x0=None, *, M=None, tol,
    # max_iter, axis_name=...) -> (x, info) signature.  A whitelist, not a
    # getattr over the whole solvers package: names like 'lobpcg' or
    # 'block_cg' exist there but have incompatible signatures and would
    # otherwise fail deep inside the jit trace with an opaque error.
    _INNER_METHODS = (
        "cg", "cg_single_sync", "bicgstab", "bicgstabl", "cgs", "tfqmr",
        "minres", "gmres", "fgmres", "idrs", "cocg", "cs_minres",
    )

    def _solver(self):
        from .errors import InvalidPreconditioner

        if self.method not in self._INNER_METHODS:
            raise InvalidPreconditioner(
                f"InnerSolvePrecond: inner method {self.method!r} is not "
                f"supported (choose one of {', '.join(self._INNER_METHODS)})"
            )
        from . import solvers

        return getattr(solvers, self.method)

    def matvec(self, r: jax.Array) -> jax.Array:
        solve = self._solver()
        z, _info = solve(
            self.A,
            r,
            M=self.inner_M,
            tol=self.inner_tol,
            max_iter=self.iters,
            axis_name=self.axis_name,
        )
        return z

    def matvec_dot(self, r: jax.Array):
        from .vecalg import conj_dot

        z = self.matvec(r)
        return z, conj_dot(r, z, self.axis_name)


jax.tree_util.register_dataclass(
    InnerSolvePrecond,
    data_fields=("A", "inner_M"),
    meta_fields=("method", "iters", "inner_tol", "axis_name"),
)
