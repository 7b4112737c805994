"""BSR (block sparse row): the dense-block layout for general sparsity.

A scalar gather per nonzero (the ELL path) moves a column index and an x
element for every entry, and pads every row to the longest.  BSR trades zero-padding for regularity the other way: nonzeros are grouped
into dense (bs × bs) blocks, the SpMV becomes a batch of dense block·vector
products (batched einsums) plus a row-block segment-sum, and the only
gather left is a *row-granular* gather of x blocks — contiguous bs-element
moves instead of scalar picks.

Economics: per stored block, traffic is bs²·4 bytes for bs nnz-columns of
useful work; worth it when the in-block fill ratio ≳ 5-10% (always true for
FEM/blocked physics matrices, and for RCM-reordered banded ones).
``fill_ratio`` reports it; ``optimize()`` can use it to route.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .containers import CSR


@dataclasses.dataclass(frozen=True)
class BSR:
    """Dense-block sparse matrix: blocks[k] sits at block-row/col coordinates."""

    blocks: jax.Array    # (nblk, bs, bs)
    blk_row: jax.Array   # (nblk,) int32, sorted
    blk_col: jax.Array   # (nblk,) int32
    padded_dim: int      # nb·bs (multiple of bs)
    n: int               # logical dimension

    @property
    def shape(self) -> Tuple[int, int]:
        # logical shape: the operator consumes/produces length-n vectors
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def bs(self) -> int:
        return self.blocks.shape[1]

    @property
    def nblk(self) -> int:
        return self.blocks.shape[0]

    @property
    def fill_ratio(self) -> float:
        """Stored-nonzero density within the dense blocks (host-side)."""
        b = np.asarray(self.blocks)
        return float((b != 0).sum() / b.size) if b.size else 0.0

    @staticmethod
    def estimate_blocks(m: CSR, bs: int) -> int:
        """Number of (bs × bs) blocks the pattern touches (pattern-only,
        no block materialization) — the routing cost model in optimize()."""
        nb = -(-m.shape[0] // bs)
        br = np.asarray(m.row_ids, dtype=np.int64) // bs
        bc = np.asarray(m.indices, dtype=np.int64) // bs
        return len(np.unique(br * nb + bc))

    def jacobi_precond(self):
        """Diagonal preconditioner on the flat layout (zero diag → inert 1)."""
        from ..precond import DiagPrecond

        d = self.diagonal()
        safe = jnp.where(d == 0, jnp.ones((), d.dtype), d)
        return DiagPrecond(diag_inv=jnp.ones((), d.dtype) / safe)

    @staticmethod
    def from_csr(m: CSR, bs: int = 128) -> "BSR":
        n = m.shape[0]
        nb = -(-n // bs)
        rows = np.asarray(m.row_ids, dtype=np.int64)
        cols = np.asarray(m.indices, dtype=np.int64)
        dat = np.asarray(m.data)
        br, bc = rows // bs, cols // bs
        key = br * nb + bc
        uniq, inv = np.unique(key, return_inverse=True)
        blocks = np.zeros((len(uniq), bs, bs), dtype=dat.dtype)
        blocks[inv, rows % bs, cols % bs] = dat
        # np.unique sorts keys → blk_row ascending (sorted segments for both
        # the in-kernel row accumulation and segment_sum)
        return BSR(
            blocks=jnp.asarray(blocks),
            blk_row=jnp.asarray((uniq // nb).astype(np.int32)),
            blk_col=jnp.asarray((uniq % nb).astype(np.int32)),
            padded_dim=nb * bs,
            n=n,
        )

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A·x on a logical-length (n,) vector: row-granular gather of x
        blocks (contiguous bs-element moves), batched block·vector products
        row segment-sum. ``precision=HIGHEST`` keeps a default-precision
        f32 einsum from running in TF32 (~3 decimal digits — a solver's
        matvec must be exact f32)."""
        bs = self.bs
        nb = self.padded_dim // bs
        xp = jnp.zeros(self.padded_dim, x.dtype).at[: self.n].set(x)
        xb = xp.reshape(nb, bs)
        gathered = jnp.take(xb, self.blk_col, axis=0)            # (nblk, bs)
        prod = jnp.einsum(
            "bij,bj->bi",
            self.blocks,
            gathered,
            preferred_element_type=jnp.result_type(self.dtype, x.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        yb = jax.ops.segment_sum(
            prod, self.blk_row, num_segments=nb, indices_are_sorted=True
        )
        return yb.reshape(-1)[: self.n]

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: jax.Array) -> jax.Array:
        bs = self.bs
        nb = self.padded_dim // bs
        k = X.shape[1]
        Xp = jnp.zeros((self.padded_dim, k), X.dtype).at[: self.n].set(X)
        Xb = Xp.reshape(nb, bs, k)
        gathered = jnp.take(Xb, self.blk_col, axis=0)            # (nblk, bs, k)
        prod = jnp.einsum(
            "bij,bjk->bik",
            self.blocks,
            gathered,
            preferred_element_type=jnp.result_type(self.dtype, X.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        Yb = jax.ops.segment_sum(
            prod, self.blk_row, num_segments=nb, indices_are_sorted=True
        )
        return Yb.reshape(-1, k)[: self.n]

    def diagonal(self) -> jax.Array:
        bs = self.bs
        on_diag = np.asarray(self.blk_row) == np.asarray(self.blk_col)
        blocks = np.asarray(self.blocks)[on_diag]
        brows = np.asarray(self.blk_row)[on_diag]
        diag = np.zeros(self.padded_dim, dtype=blocks.dtype)
        for b, br in zip(blocks, brows):
            diag[br * bs : (br + 1) * bs] = np.diag(b)
        return jnp.asarray(diag[: self.n])


jax.tree_util.register_dataclass(
    BSR, data_fields=("blocks", "blk_row", "blk_col"), meta_fields=("padded_dim", "n")
)


@dataclasses.dataclass(frozen=True)
class ComplexBSR:
    """Two-plane BSR: the block path for *unstructured complex* matrices.

    The reference's MKL backend runs arbitrary complex CSR at memory speed
    (``src/mkl_mat.rs:32-74,170-319``, the c/z creation and mv macros); this
    is the counterpart here.  A complex SpMV over a block pattern decomposes
    into four real block-batch products on the shared union pattern:
    y_re = A_re·x_re − A_im·x_im, y_im = A_re·x_im + A_im·x_re — executed as
    TWO batched einsums (each with the (x_re, x_im) planes stacked as a
    k=2 rhs) plus one plane-stacked row segment-sum.

    Storage is real re/im block planes, so the two products run as real
    einsums over a shared pattern; the complex view is formed at the
    operator boundary.
    """

    blocks_re: jax.Array   # (nblk, bs, bs) real plane
    blocks_im: jax.Array   # (nblk, bs, bs) real plane (union pattern)
    blk_row: jax.Array     # (nblk,) int32, sorted
    blk_col: jax.Array     # (nblk,) int32
    padded_dim: int
    n: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return jnp.dtype(
            jnp.result_type(self.blocks_re.dtype, jnp.complex64)
        )

    @property
    def bs(self) -> int:
        return self.blocks_re.shape[1]

    @property
    def nblk(self) -> int:
        return self.blocks_re.shape[0]

    @staticmethod
    def from_csr(m: CSR, bs: int = 128) -> "ComplexBSR":
        n = m.shape[0]
        nb = -(-n // bs)
        rows = np.asarray(m.row_ids, dtype=np.int64)
        cols = np.asarray(m.indices, dtype=np.int64)
        dat = np.asarray(m.data)
        rdt = dat.real.dtype
        br, bc = rows // bs, cols // bs
        key = br * nb + bc
        uniq, inv = np.unique(key, return_inverse=True)
        blocks_re = np.zeros((len(uniq), bs, bs), dtype=rdt)
        blocks_im = np.zeros((len(uniq), bs, bs), dtype=rdt)
        blocks_re[inv, rows % bs, cols % bs] = dat.real
        blocks_im[inv, rows % bs, cols % bs] = dat.imag
        return ComplexBSR(
            blocks_re=jnp.asarray(blocks_re),
            blocks_im=jnp.asarray(blocks_im),
            blk_row=jnp.asarray((uniq // nb).astype(np.int32)),
            blk_col=jnp.asarray((uniq % nb).astype(np.int32)),
            padded_dim=nb * bs,
            n=n,
        )

    def _planes_matvec(self, xr: jax.Array, xi: jax.Array):
        """Core two-plane apply on real (n,) planes → real (n,) planes."""
        bs = self.bs
        nb = self.padded_dim // bs
        prec = jax.lax.Precision.HIGHEST

        def blockify(v):
            vp = jnp.zeros(self.padded_dim, v.dtype).at[: self.n].set(v)
            return vp.reshape(nb, bs)

        # one gather of the stacked planes: (nblk, bs, 2)
        g = jnp.take(
            jnp.stack([blockify(xr), blockify(xi)], axis=-1),
            self.blk_col, axis=0,
        )
        out_t = jnp.result_type(self.blocks_re.dtype, xr.dtype)
        pr = jnp.einsum("bij,bjk->bik", self.blocks_re, g,
                        preferred_element_type=out_t, precision=prec)
        pi = jnp.einsum("bij,bjk->bik", self.blocks_im, g,
                        preferred_element_type=out_t, precision=prec)
        # combine planes BEFORE the segment-sum (linear; halves segment work)
        stacked = jnp.stack(
            [pr[..., 0] - pi[..., 1], pr[..., 1] + pi[..., 0]], axis=-1
        )
        Y = jax.ops.segment_sum(
            stacked, self.blk_row, num_segments=nb, indices_are_sorted=True
        )
        yr = Y[..., 0].reshape(-1)[: self.n]
        yi = Y[..., 1].reshape(-1)[: self.n]
        return yr, yi

    def matvec(self, x: jax.Array) -> jax.Array:
        yr, yi = self._planes_matvec(jnp.real(x), jnp.imag(x))
        return (yr + 1j * yi).astype(jnp.result_type(x.dtype, self.dtype))

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: jax.Array) -> jax.Array:
        bs = self.bs
        nb = self.padded_dim // bs
        k = X.shape[1]
        prec = jax.lax.Precision.HIGHEST
        Xr, Xi = jnp.real(X), jnp.imag(X)

        def blockify(V):
            Vp = jnp.zeros((self.padded_dim, k), V.dtype).at[: self.n].set(V)
            return Vp.reshape(nb, bs, k)

        g = jnp.concatenate(
            [jnp.take(blockify(Xr), self.blk_col, axis=0),
             jnp.take(blockify(Xi), self.blk_col, axis=0)], axis=-1
        )  # (nblk, bs, 2k): [re | im]
        out_t = jnp.result_type(self.blocks_re.dtype, Xr.dtype)
        pr = jnp.einsum("bij,bjk->bik", self.blocks_re, g,
                        preferred_element_type=out_t, precision=prec)
        pi = jnp.einsum("bij,bjk->bik", self.blocks_im, g,
                        preferred_element_type=out_t, precision=prec)
        stacked = jnp.concatenate(
            [pr[..., :k] - pi[..., k:], pr[..., k:] + pi[..., :k]], axis=-1
        )
        Y = jax.ops.segment_sum(
            stacked, self.blk_row, num_segments=nb, indices_are_sorted=True
        )
        Yr = Y[..., :k].reshape(-1, k)[: self.n]
        Yi = Y[..., k:].reshape(-1, k)[: self.n]
        return (Yr + 1j * Yi).astype(jnp.result_type(X.dtype, self.dtype))

    def diagonal(self) -> jax.Array:
        """Complex diagonal (host-side build, like :meth:`BSR.diagonal`)."""
        bs = self.bs
        on_diag = np.asarray(self.blk_row) == np.asarray(self.blk_col)
        bre = np.asarray(self.blocks_re)[on_diag]
        bim = np.asarray(self.blocks_im)[on_diag]
        brows = np.asarray(self.blk_row)[on_diag]
        diag = np.zeros(self.padded_dim, dtype=np.result_type(bre.dtype, np.complex64))
        for r_, i_, br_ in zip(bre, bim, brows):
            diag[br_ * bs : (br_ + 1) * bs] = np.diag(r_) + 1j * np.diag(i_)
        return diag[: self.n]

    def jacobi_precond(self):
        """Complex Jacobi preconditioner as re/im planes (zero diag → inert 1)."""
        from ..precond import ComplexDiagPrecond

        d = self.diagonal()  # host numpy
        d = np.where(d == 0, np.ones((), d.dtype), d)
        return ComplexDiagPrecond.new(d)


jax.tree_util.register_dataclass(
    ComplexBSR,
    data_fields=("blocks_re", "blocks_im", "blk_row", "blk_col"),
    meta_fields=("padded_dim", "n"),
)
