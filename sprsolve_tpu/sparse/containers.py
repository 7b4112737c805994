"""Sparse containers as JAX pytrees.

Replaces the reference's ``sprs``-based storage (``src/mat.rs``) with formats
chosen for an accelerator's memory system rather than for pointer-chasing
CPUs:

- COO: build format; SpMV = gather + segment-sum (the correctness oracle).
- CSR: interchange format; carries a precomputed COO-style ``row_ids`` array so
  its SpMV is static-shaped (XLA needs static shapes; ``indptr`` walking is a
  CPU idiom).

Build/interchange formats (COO/CSR/CSC) keep **host** (NumPy) arrays — they
are assembled, analyzed and converted on the host; device placement happens
when an *execution* format (ELL/DIA/BSR) is built or when jnp ops consume
them. This avoids device round-trips during assembly.
- ELL: every row padded to ``k`` entries → dense (n, k) tiles, regular
  access; pad entries have value 0 and column 0 (they contribute nothing).
- DIA: offset-diagonal storage for banded/stencil matrices; SpMV uses shifted
  contiguous slices instead of gathers (no irregular memory access at all).

The matvec entry points are in ``sprsolve_tpu.ops.spmv``; containers expose
``matvec``/``matvec_dot`` convenience methods implementing the reference's
``MatVecMul`` trait surface (``src/mat.rs:12-37``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


def _scatter_sum(idx, dat, size):
    """Host-side duplicate-summing scatter: out[idx[k]] += dat[k].

    ``np.bincount`` instead of ``np.add.at`` — add.at is the unbuffered
    ufunc path (~20x slower at the multi-M-nnz sizes preconditioner setup
    runs at; it was the dominant cost of the 1M-row multigrid hierarchy
    build).  bincount only takes real weights, so complex sums in two
    passes."""
    idx = np.asarray(idx, np.int64)
    if np.iscomplexobj(dat):
        out = np.bincount(idx, weights=dat.real, minlength=size).astype(
            dat.dtype
        )
        out += 1j * np.bincount(idx, weights=dat.imag, minlength=size)
        return out
    return np.bincount(idx, weights=dat, minlength=size).astype(dat.dtype)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix. Duplicate (row, col) entries sum."""

    data: jax.Array   # (nnz,)
    row: jax.Array    # (nnz,) int32
    col: jax.Array    # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    def matvec(self, x: jax.Array) -> jax.Array:
        from ..ops.spmv import spmv_coo

        return spmv_coo(self, x)

    def matvec_dot(self, x: jax.Array):
        """Fused A·x and conj(x)·(A·x) — reference ``mul_vec_dot`` (src/mat.rs:19-22)."""
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def to_csr(self) -> "CSR":
        return CSR.from_coo(self)

    def todense(self) -> jax.Array:
        # host-side, mirroring CSR.todense (build formats keep host arrays)
        flat = np.asarray(self.row, np.int64) * self.shape[1] + np.asarray(
            self.col, np.int64
        )
        dense = _scatter_sum(flat, np.asarray(self.data), int(np.prod(self.shape)))
        return jnp.asarray(dense.reshape(self.shape))


_register(COO, data_fields=("data", "row", "col"), meta_fields=("shape",))


@dataclasses.dataclass(frozen=True)
class CSR:
    """CSR with a precomputed flat ``row_ids`` companion (static-shape SpMV).

    ``indptr`` is kept for format fidelity/conversion; the compute path uses
    (data, indices, row_ids) as a sorted COO.
    """

    data: jax.Array      # (nnz,)
    indices: jax.Array   # (nnz,) int32 column index per entry
    indptr: jax.Array    # (n_rows + 1,) int32
    row_ids: jax.Array   # (nnz,) int32 row index per entry
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def from_arrays(data, indices, indptr, shape) -> "CSR":
        indptr_np = np.asarray(indptr, dtype=np.int64)
        row_ids = np.repeat(
            np.arange(shape[0], dtype=np.int32), np.diff(indptr_np)
        )
        return CSR(
            data=np.asarray(data),
            indices=np.asarray(indices, dtype=np.int32),
            indptr=indptr_np.astype(np.int32),
            row_ids=row_ids,
            shape=tuple(shape),
        )

    @staticmethod
    def from_coo(m: COO) -> "CSR":
        row = np.asarray(m.row)
        col = np.asarray(m.col)
        dat = np.asarray(m.data)
        # sum duplicates; np.unique sorts the keys, which IS the row-major
        # (row, col) order — no separate lexsort needed
        key = row.astype(np.int64) * m.shape[1] + col
        uniq, inv = np.unique(key, return_inverse=True)
        dat_sum = _scatter_sum(inv, dat, len(uniq))
        row_u = (uniq // m.shape[1]).astype(np.int32)
        col_u = (uniq % m.shape[1]).astype(np.int32)
        indptr = np.zeros(m.shape[0] + 1, dtype=np.int64)
        counts = np.bincount(row_u, minlength=m.shape[0])
        indptr[1:] = np.cumsum(counts)
        return CSR.from_arrays(dat_sum, col_u, indptr, m.shape)

    def matvec(self, x: jax.Array) -> jax.Array:
        from ..ops.spmv import spmv_csr

        return spmv_csr(self, x)

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: jax.Array) -> jax.Array:
        """Y = A·X, multi-RHS SpMM."""
        from ..ops.spmv import spmm_csr

        return spmm_csr(self, X)

    def to_ell(self, k: int | None = None) -> "ELL":
        return ELL.from_csr(self, k=k)

    def to_dia(self) -> "DIA":
        return DIA.from_csr(self)

    def transpose(self, conj: bool = False) -> "CSR":
        """Aᵀ (or Aᴴ with ``conj=True``) as a new CSR — host-side, rectangular
        ok. Built once at setup time, the adjoint pairs with :func:`lsqr` and
        normal-equation methods (no per-iteration transposed gathers)."""
        rows = np.asarray(self.row_ids, np.int64)
        cols = np.asarray(self.indices, np.int64)
        dat = np.asarray(self.data)
        if conj:
            dat = np.conj(dat)
        order = np.lexsort((rows, cols))
        m, n = self.shape
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, cols[order] + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSR.from_arrays(
            dat[order], rows[order].astype(np.int32), indptr, (n, m)
        )

    def adjoint(self) -> "CSR":
        """Aᴴ = conj(A)ᵀ (equals :meth:`transpose` for real dtypes)."""
        return self.transpose(conj=True)

    def diagonal(self) -> jax.Array:
        """Extract the main diagonal (host-side, for preconditioner setup)."""
        return jnp.asarray(self.diagonal_host())

    def diagonal_host(self) -> np.ndarray:
        """Main diagonal as a host array — preconditioner setup composes
        several host-side passes and must not round-trip the device."""
        dat = np.asarray(self.data)
        on_diag = np.asarray(self.row_ids) == np.asarray(self.indices)
        return _scatter_sum(
            np.asarray(self.row_ids)[on_diag], dat[on_diag], self.shape[0]
        )

    def todense(self) -> jax.Array:
        return jnp.asarray(self.todense_host())

    def todense_host(self) -> np.ndarray:
        # host-side (build formats keep host arrays): avoids an XLA
        # scatter compile + device round-trip on the preconditioner-setup path
        flat = np.asarray(self.row_ids, np.int64) * self.shape[1] + np.asarray(
            self.indices, np.int64
        )
        dense = _scatter_sum(flat, np.asarray(self.data), int(np.prod(self.shape)))
        return dense.reshape(self.shape)


_register(
    CSR,
    data_fields=("data", "indices", "indptr", "row_ids"),
    meta_fields=("shape",),
)


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: each row padded to ``k`` slots — the general execution layout.

    Pad slots carry (col=0, val=0). Analog of the reference's
    ``mkl_sparse_optimize`` layout conversion (``src/mkl_mat.rs:112-116``):
    built once at operator construction, then every SpMV is regular.
    """

    data: jax.Array   # (n_rows, k)
    cols: jax.Array   # (n_rows, k) int32
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def k(self) -> int:
        return self.data.shape[1]

    @property
    def nnz_padded(self) -> int:
        return self.data.shape[0] * self.data.shape[1]

    @staticmethod
    def from_csr(m: CSR, k: int | None = None) -> "ELL":
        indptr = np.asarray(m.indptr, dtype=np.int64)
        counts = np.diff(indptr)
        kmax = int(counts.max()) if len(counts) else 0
        if k is None:
            k = kmax
        if k < kmax:
            raise ValueError(f"k={k} < max row nnz {kmax}")
        n = m.shape[0]
        data = np.zeros((n, k), dtype=np.asarray(m.data).dtype)
        cols = np.zeros((n, k), dtype=np.int32)
        flat_dat = np.asarray(m.data)
        flat_col = np.asarray(m.indices)
        # scatter each row's entries into its padded slots
        slot = np.arange(len(flat_dat)) - np.repeat(indptr[:-1], counts)
        rows = np.repeat(np.arange(n), counts)
        data[rows, slot] = flat_dat
        cols[rows, slot] = flat_col
        return ELL(data=jnp.asarray(data), cols=jnp.asarray(cols), shape=m.shape)

    def matvec(self, x: jax.Array) -> jax.Array:
        from ..ops.spmv import spmv_ell

        return spmv_ell(self, x)

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: jax.Array) -> jax.Array:
        from ..ops.spmv import spmm_ell

        return spmm_ell(self, X)

    def diagonal(self) -> jax.Array:
        n = self.shape[0]
        rows = jnp.arange(n, dtype=jnp.int32)[:, None]
        on_diag = self.cols == rows
        return jnp.sum(jnp.where(on_diag, self.data, 0), axis=1)


_register(ELL, data_fields=("data", "cols"), meta_fields=("shape",))


@dataclasses.dataclass(frozen=True)
class DIA:
    """Offset-diagonal (banded) storage: y[i] = Σ_d bands[d, i] · x[i + offsets[d]].

    Band values are stored at their *row* index; entries whose column
    ``i + off`` falls outside [0, n) must be zero.  For stencil matrices this
    turns every x-access into a contiguous shifted slice — no gathers at all
    (HBM-bandwidth bound at ~4 bytes/nnz for f32 bands instead of 8-12 with
    explicit indices).

    ``vdtype`` is set when the bands are stored narrower than the dtype the
    operator computes in (see :meth:`narrow`); the bands are then widened
    in registers inside the fused SpMV.
    """

    bands: jax.Array          # (n_diags, n_rows)
    offsets: Tuple[int, ...]  # static
    shape: Tuple[int, int]
    vdtype: Optional[str] = None

    @property
    def dtype(self):
        return jnp.dtype(self.vdtype) if self.vdtype else self.bands.dtype

    def narrow(self) -> "DIA":
        """The same operator with f32 bands stored in the narrowest dtype
        that represents every value EXACTLY: int8 for small integers, else
        bfloat16, else unchanged.  Band bytes dominate a stencil SpMV
        (D of its D+2 streams), so this cuts its memory traffic with
        bit-identical results; never lossy."""
        bands = np.asarray(self.bands)
        if self.vdtype or bands.dtype != np.float32 or bands.size == 0:
            return self
        if np.abs(bands).max() <= 127 and np.all(bands == np.round(bands)):
            narrow = bands.astype(np.int8)
        else:
            import ml_dtypes

            narrow = bands.astype(ml_dtypes.bfloat16)
            if not np.array_equal(narrow.astype(np.float32), bands):
                return self
        return DIA(bands=jnp.asarray(narrow), offsets=self.offsets,
                   shape=self.shape, vdtype="float32")

    @staticmethod
    def arrays_from_csr(m: CSR, max_diags: int = 64):
        """Host-side band extraction: (bands ndarray, offsets tuple)."""
        row = np.asarray(m.row_ids, dtype=np.int64)
        col = np.asarray(m.indices, dtype=np.int64)
        dat = np.asarray(m.data)
        offs = np.unique(col - row)
        if len(offs) > max_diags:
            raise ValueError(
                f"matrix has {len(offs)} distinct diagonals (> {max_diags}); "
                "DIA is only efficient for banded/stencil matrices — use ELL"
            )
        n = m.shape[0]
        # offs is sorted-unique, so searchsorted is the vectorized inverse
        # of the offset→band-row map (a per-entry Python dict walk here was
        # the dominant cost of multigrid setup at 1M rows)
        drow = np.searchsorted(offs, col - row)
        bands = _scatter_sum(drow * n + row, dat, len(offs) * n).reshape(
            len(offs), n
        )
        return bands, tuple(int(o) for o in offs)

    @staticmethod
    def from_csr(m: CSR, max_diags: int = 64) -> "DIA":
        bands, offsets = DIA.arrays_from_csr(m, max_diags=max_diags)
        return DIA(bands=jnp.asarray(bands), offsets=offsets, shape=m.shape)

    def matvec(self, x: jax.Array) -> jax.Array:
        from ..ops.spmv import spmv_dia

        return spmv_dia(self, x)

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: jax.Array) -> jax.Array:
        from ..ops.spmv import spmm_dia

        return spmm_dia(self, X)

    def diagonal(self) -> jax.Array:
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)].astype(self.dtype)
        return jnp.zeros(self.shape[0], dtype=self.dtype)


_register(DIA, data_fields=("bands",), meta_fields=("offsets", "shape", "vdtype"))


@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column. The reference supports CSC views with an
    unoptimized SpMV fallback (``src/mat.rs:130-142``); here CSC is an
    interchange format whose SpMV goes through the same flat scatter path
    (col-major COO + segment-sum over rows)."""

    data: jax.Array      # (nnz,)
    indices: jax.Array   # (nnz,) int32 row index per entry
    indptr: jax.Array    # (n_cols + 1,) int32
    col_ids: jax.Array   # (nnz,) int32 column index per entry
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def from_arrays(data, indices, indptr, shape) -> "CSC":
        indptr_np = np.asarray(indptr, dtype=np.int64)
        col_ids = np.repeat(np.arange(shape[1], dtype=np.int32), np.diff(indptr_np))
        return CSC(
            data=np.asarray(data),
            indices=np.asarray(indices, dtype=np.int32),
            indptr=indptr_np.astype(np.int32),
            col_ids=col_ids,
            shape=tuple(shape),
        )

    def matvec(self, x: jax.Array) -> jax.Array:
        # y[row] += a[row, col] * x[col] — scatter-add over rows, the same
        # shape as the reference's per-column accumulation loop.
        contrib = self.data * jnp.take(x, self.col_ids)
        return jax.ops.segment_sum(
            contrib, self.indices, num_segments=self.shape[0]
        )

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def to_csr(self) -> "CSR":
        coo = COO(
            data=self.data, row=self.indices, col=self.col_ids, shape=self.shape
        )
        return CSR.from_coo(coo)

    def diagonal(self) -> jax.Array:
        dat = np.asarray(self.data)
        on_diag = np.asarray(self.indices) == np.asarray(self.col_ids)
        diag = np.zeros(self.shape[0], dtype=dat.dtype)
        np.add.at(diag, np.asarray(self.indices)[on_diag], dat[on_diag])
        return jnp.asarray(diag)

    def todense(self) -> jax.Array:
        out = jnp.zeros(self.shape, dtype=self.dtype)
        return out.at[self.indices, self.col_ids].add(self.data)


_register(
    CSC,
    data_fields=("data", "indices", "indptr", "col_ids"),
    meta_fields=("shape",),
)


def reorder_rcm(m: CSR):
    """Symmetric RCM reordering: returns (permuted CSR, perm) with
    A'[i, j] = A[perm[i], perm[j]].  Reduces bandwidth so banded execution
    layouts (DIA/BSR-along-the-band) apply to general matrices; solve with
    A' and b[perm], then undo with x[inv_perm] (see ``native.rcm_order``).
    """
    from ..native import rcm_order, symmetrize_pattern

    n = m.shape[0]
    indptr = np.asarray(m.indptr, np.int64)
    indices = np.asarray(m.indices, np.int32)
    sym_indptr, sym_indices = symmetrize_pattern(n, indptr, indices)
    perm = rcm_order(n, sym_indptr, sym_indices)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    rows = inv[np.asarray(m.row_ids, np.int64)]
    cols = inv[np.asarray(m.indices, np.int64)]
    coo = COO(
        data=np.asarray(m.data),
        row=rows.astype(np.int32),
        col=cols.astype(np.int32),
        shape=m.shape,
    )
    return CSR.from_coo(coo), perm


def csr_from_scipy(m) -> CSR:
    """Build from a scipy.sparse matrix (any format)."""
    m = m.tocsr()
    return CSR.from_arrays(m.data, m.indices, m.indptr, m.shape)


def csr_from_bcoo(m) -> CSR:
    """Build from a ``jax.experimental.sparse`` BCOO/BCSR matrix (interop for
    users arriving from JAX's own sparse module). Duplicates are summed."""
    if hasattr(m, "to_bcoo"):  # BCSR
        m = m.to_bcoo()
    idx = np.asarray(m.indices)
    dat = np.asarray(m.data)
    if idx.ndim != 2 or idx.shape[1] != 2 or dat.ndim != 1:
        raise ValueError(
            "csr_from_bcoo supports unbatched rank-2 BCOO (n_batch=0, "
            "n_dense=0)"
        )
    nrows, ncols = (int(s) for s in m.shape)
    # BCOO pads unused nse slots with out-of-range indices (== shape);
    # drop them instead of crashing in the CSR build
    keep = (idx[:, 0] < nrows) & (idx[:, 1] < ncols)
    return CSR.from_coo(
        COO(
            data=dat[keep],
            row=idx[keep, 0].astype(np.int32),
            col=idx[keep, 1].astype(np.int32),
            shape=(nrows, ncols),
        )
    )


def csr_from_dense(a) -> CSR:
    """Build from a dense array (test convenience)."""
    a = np.asarray(a)
    nz = np.nonzero(a)
    coo = COO(
        data=jnp.asarray(a[nz]),
        row=jnp.asarray(nz[0].astype(np.int32)),
        col=jnp.asarray(nz[1].astype(np.int32)),
        shape=a.shape,
    )
    return CSR.from_coo(coo)
