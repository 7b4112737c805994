"""Multicolor (red-black) Gauss-Seidel: the data-parallel reformulation.

True Gauss-Seidel sweeps are sequential over rows (``src/gauss_seidel.rs:111-125``)
and cannot vectorize.  The classical fix is graph coloring: partition rows
into color classes with no intra-class couplings; rows within a class update
*simultaneously* (a dense vectorized operation), classes update in sequence.
For 5/7-point grid stencils two colors suffice (red-black ordering); a greedy
host-side coloring handles general sparsity.

Convergence behavior differs from the natural-order sweep (classical result;
same asymptotic rate for consistently-ordered matrices) — this is a documented
deviation (SURVEY.md §7 "Gauss-Seidel sequentiality"), which is why the exact
sequential sweep is kept separately in ``gauss_seidel.py`` for parity tests.

Also provides :class:`MulticolorGSPrecond` — k sweeps from z = 0 as a fixed
linear operator, the "Gauss-Seidel preconditioner" of BASELINE.md config #4.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..errors import Status
from ..sparse.containers import CSR, ELL
from ..vecalg import abs2, axpy, eps_for, norm2
from .common import make_info


def greedy_color(csr: CSR) -> np.ndarray:
    """Greedy row coloring of the symmetrized adjacency (host-side).

    Rows i, j conflict if a_ij ≠ 0 or a_ji ≠ 0 (GS reads neighbors' x).
    Runs in the native hostkit (O(nnz) C++) with a NumPy fallback."""
    from ..native import greedy_color as _native_color, symmetrize_pattern

    n = csr.shape[0]
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = np.asarray(csr.indices, dtype=np.int32)
    sym_indptr, sym_indices = symmetrize_pattern(n, indptr, indices)
    return _native_color(n, sym_indptr, sym_indices)


@dataclasses.dataclass(frozen=True)
class ColoredELL:
    """ELL rows regrouped by color for parallel-within-class GS updates.

    ``perm`` maps [color-block position] → original row id;
    ``data``/``cols`` are the (permuted-row, k) off-diagonal-inclusive ELL
    slabs; ``diag`` is the permuted diagonal; ``starts`` delimits the color
    blocks (static, so each class update is a static slice).
    """

    data: jax.Array        # (n, k) permuted rows
    cols: jax.Array        # (n, k) global column ids
    diag: jax.Array        # (n,) permuted
    perm: jax.Array        # (n,) int32
    starts: Tuple[int, ...]  # len n_colors+1, static
    shape: Tuple[int, int]

    @property
    def n_colors(self) -> int:
        return len(self.starts) - 1

    @staticmethod
    def from_csr(csr: CSR, colors: Optional[np.ndarray] = None) -> "ColoredELL":
        if colors is None:
            colors = greedy_color(csr)
        n = csr.shape[0]
        order = np.argsort(colors, kind="stable").astype(np.int32)
        counts = np.bincount(colors)
        starts = tuple(int(s) for s in np.concatenate([[0], np.cumsum(counts)]))
        ell = ELL.from_csr(csr)
        data = np.asarray(ell.data)[order]
        cols = np.asarray(ell.cols)[order]
        diag = np.asarray(csr.diagonal())[order]
        return ColoredELL(
            data=jnp.asarray(data),
            cols=jnp.asarray(cols),
            diag=jnp.asarray(diag),
            perm=jnp.asarray(order),
            starts=starts,
            shape=csr.shape,
        )

    def sweep(self, b: jax.Array, x: jax.Array) -> jax.Array:
        """One multicolor sweep: for each color class (in order), update all
        its rows simultaneously using the current x."""
        for c in range(self.n_colors):
            s, e = self.starts[c], self.starts[c + 1]
            rows = self.perm[s:e]
            vals = self.data[s:e]
            cls = self.cols[s:e]
            xs = jnp.take(x, cls, axis=0)              # (m, k)
            off = cls != rows[:, None]
            sigma = jnp.sum(jnp.where(off, vals * xs, 0), axis=1)
            xi = (jnp.take(b, rows) - sigma) / self.diag[s:e]
            x = x.at[rows].set(xi)
        return x


jax.tree_util.register_dataclass(
    ColoredELL,
    data_fields=("data", "cols", "diag", "perm"),
    meta_fields=("starts", "shape"),
)


class _State(NamedTuple):
    x: jax.Array
    it: jax.Array
    status: jax.Array
    res: jax.Array


def gauss_seidel_redblack(
    A: ColoredELL,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    max_iter,
    eps,
):
    """Multicolor GS solve with the same convergence criterion and iteration
    counting as the sequential solver (absolute residual ‖Ax−b‖ ≤ eps·‖b‖,
    ``src/gauss_seidel.rs:87-108``)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)

    rdt = jnp.finfo(b.dtype).dtype if not jnp.iscomplexobj(b) else jnp.real(b).dtype
    eps_arg = jnp.asarray(eps, dtype=rdt)
    max_iter = jnp.asarray(max_iter, dtype=jnp.int32)
    machine_eps = eps_for(b.dtype)

    bad_diag = jnp.any(abs2(A.diag) < machine_eps)
    tol2 = eps_arg * norm2(b)
    one_t = jnp.ones((), b.dtype)

    def residual(x):
        # full SpMV via the permuted slabs (equivalent to A·x)
        contrib = jnp.sum(A.data * jnp.take(x, A.cols, axis=0), axis=1)
        ax = jnp.zeros_like(x).at[A.perm].set(contrib)
        return norm2(axpy(-one_t, b, ax))

    def failed(_):
        return x0, make_info(0, jnp.zeros((), rdt), Status.ZERO_DIAGONAL)

    def insufficient(_):
        return x0, make_info(0, jnp.zeros((), rdt), Status.INSUFFICIENT_ITER)

    def run(_):
        x1 = A.sweep(b, x0)
        res1 = residual(x1)

        def first_conv(_):
            return x1, make_info(1, res1, Status.CONVERGED)

        def iterate(_):
            st0 = _State(x1, jnp.int32(1), jnp.int32(Status.RUNNING), res1)

            def cond_fn(s_):
                return (s_.status == Status.RUNNING) & (s_.it < max_iter)

            def body_fn(s_):
                x = A.sweep(b, s_.x)
                res = residual(x)
                conv = res <= tol2
                return _State(
                    x=x,
                    it=jnp.where(conv, s_.it, s_.it + 1),
                    status=jnp.where(conv, jnp.int32(Status.CONVERGED), s_.status),
                    res=res,
                )

            fin = lax.while_loop(cond_fn, body_fn, st0)
            status = jnp.where(
                fin.status == Status.RUNNING,
                jnp.int32(Status.INSUFFICIENT_ITER),
                fin.status,
            )
            return fin.x, make_info(fin.it, fin.res, status)

        return lax.cond(res1 <= tol2, first_conv, iterate, None)

    def checked(_):
        return lax.cond(bad_diag, failed, run, None)

    return lax.cond(max_iter == 0, insufficient, checked, None)


@dataclasses.dataclass(frozen=True)
class MaskedGSPrecond:
    """Multicolor Gauss-Seidel sweeps expressed as masked whole-vector updates.

    For each color class c (in order):
        z ← where(mask_c, (r − (A·z − d⊙z)) / d, z)

    Each masked update recomputes A·z with the *current* z, so classes see
    earlier classes' updates within the sweep — exact multicolor GS — but the
    computation is one full SpMV + elementwise ops per color: it runs through
    whatever operator is supplied, including the XLA DIA path, with no
    gathers.  Cost: n_colors SpMVs per sweep (2 for stencil checkerboards).

    Works on flat or padded-2D vectors; masks must be in the same layout
    (padded entries False, so they stay inert).  With z₀ = 0 the map r ↦ z is
    a fixed linear operator — valid as a Krylov preconditioner.

    ``omega`` over-relaxes each masked update (SOR); ``symmetric=True`` runs
    the color classes forward then backward per sweep — multicolor
    SGS/SSOR.  For symmetric A the symmetric apply is a symmetric map, so it
    passes MINRES's β² gate and is valid for CG (the accelerator-friendly
    stand-in for the triangular-solve SSOR of CPU libraries).
    """

    A: object                    # any LinearOperator (DIA/BSR/...)
    diag: jax.Array              # same layout as vectors
    masks: Tuple[jax.Array, ...]  # one boolean mask per color, vector layout
    sweeps: int = 1
    omega: float = 1.0
    symmetric: bool = False

    @property
    def shape(self):
        return self.A.shape

    def pspec(self, axis_name: str) -> "MaskedGSPrecond":
        """Partition specs for shard_map (distributed GS preconditioning):
        the inner operator supplies its own, diag/masks shard with rows."""
        import jax as _jax
        from jax.sharding import PartitionSpec as _P

        inner = (
            self.A.pspec(axis_name)
            if hasattr(self.A, "pspec")
            else _jax.tree.map(lambda _: _P(axis_name), self.A)
        )
        return MaskedGSPrecond(
            A=inner,
            diag=_P(axis_name),
            masks=tuple(_P(axis_name) for _ in self.masks),
            sweeps=self.sweeps,
            omega=self.omega,
            symmetric=self.symmetric,
        )

    def matvec(self, r: jax.Array) -> jax.Array:
        # pad/halo coordinates: diag is structurally 0 there; divide-by-zero
        # is masked out but still poisons XLA's where unless guarded.
        safe_diag = jnp.where(self.diag == 0, jnp.ones((), self.diag.dtype), self.diag)
        om = jnp.asarray(self.omega, safe_diag.dtype)
        z = jnp.zeros_like(r)
        first = True
        order = tuple(self.masks)
        if self.symmetric:
            # palindrome without repeating the middle color: rows within a
            # color have no coupling, so the textbook SSOR's back-to-back
            # middle update would be an extra SpMV for (at ω=1 exactly) no
            # change; the single-middle palindrome stays symmetric
            order = order + order[::-1][1:]
        for _ in range(self.sweeps):
            for mask in order:
                if first:
                    # z = 0 ⇒ A·z = 0: skip the SpMV of the very first update
                    zi = om * r / safe_diag
                    first = False
                else:
                    az = self.A.matvec(z)
                    zi = z + om * (r - az) / safe_diag
                z = jnp.where(mask, zi, z)
        return z

    def matvec_dot(self, r: jax.Array):
        from ..vecalg import conj_dot

        z = self.matvec(r)
        return z, conj_dot(r, z)


jax.tree_util.register_dataclass(
    MaskedGSPrecond,
    data_fields=("A", "diag", "masks"),
    meta_fields=("sweeps", "omega", "symmetric"),
)


def color_masks(colors: np.ndarray) -> Tuple[jax.Array, ...]:
    """Boolean masks per color class, flat layout."""
    n_colors = int(colors.max()) + 1
    return tuple(jnp.asarray(colors == c) for c in range(n_colors))


@dataclasses.dataclass(frozen=True)
class MulticolorGSPrecond:
    """M⁻¹·r ≈ k multicolor GS sweeps on A·z = r from z = 0.

    A fixed linear operator (z₀ = 0 makes the sweep map linear in r), usable
    as the preconditioner in BiCGStab — BASELINE.md config #4's
    "BiCGStab + Gauss-Seidel preconditioner"."""

    A: ColoredELL
    sweeps: int = 1

    @property
    def shape(self):
        return self.A.shape

    def matvec(self, r: jax.Array) -> jax.Array:
        z = jnp.zeros_like(r)
        for _ in range(self.sweeps):
            z = self.A.sweep(r, z)
        return z

    def matvec_dot(self, r: jax.Array):
        from ..vecalg import conj_dot

        z = self.matvec(r)
        return z, conj_dot(r, z)


jax.tree_util.register_dataclass(
    MulticolorGSPrecond, data_fields=("A",), meta_fields=("sweeps",)
)
