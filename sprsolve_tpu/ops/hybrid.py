"""Hybrid band+outlier operator: banded DIA core + tiny COO rest.

Closes the fast-path cliff of the layout optimizer: one long-range row — a
constraint coupling, a global Lagrange multiplier, a periodic-boundary
stitch — makes the diagonal count explode past every DIA/RCM threshold, and
the whole matrix used to fall to the ELL gather path.  The fix mirrors the
classical HYB format (Bell & Garland's ELL+COO split), re-targeted at this
package's band decomposition: keep the offsets that carry almost all the
nnz as a DIA core, and spill the few remaining entries to a coordinate
sidecar applied with a scatter-add.

The sidecar's per-element cost is the measured gather+scatter rate
(``SCATTER_BYTES_EQ`` in ``ops/optimize.py``), which is why it must stay
SMALL: ``optimize()`` prices it explicitly against the other layouts and
only routes here when the split wins.  For truly unstructured patterns (no
dominant offsets) the split cannot win; for the large practical class of
"structured + a few couplings" matrices it keeps the banded speed.

Reference bar: ``mkl_sparse_?_mv`` serves arbitrary CSR at memory speed
(``/root/reference/src/mkl_mat.rs:170-239``); the equivalent *contract* here
(no structural prerequisites, never a silent cliff) is met by this split
plus the optimizer's pricing.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.containers import CSR, DIA


@dataclasses.dataclass(frozen=True)
class HybridDIA:
    """Banded core (flat-vector operator) + sorted-COO outlier sidecar.

    ``core`` is the banded ``DIA``; outliers are (row, col, val) arrays
    sorted by row.  The operator works on flat vectors — no ``pad_vec`` —
    so every solver and preconditioner composes unchanged.
    """

    core: object
    out_rows: jax.Array   # (m,) int32, sorted
    out_cols: jax.Array   # (m,) int32
    out_vals: jax.Array   # (m,)
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.out_vals.dtype

    @property
    def n_outliers(self) -> int:
        return int(self.out_vals.shape[0])

    @staticmethod
    def from_csr(
        m: CSR,
        *,
        max_diags: int = 32,
        max_outliers: int | None = None,
    ) -> "HybridDIA":
        """Split ``m`` into its ``max_diags`` heaviest offsets + the rest.

        Raises ``ValueError`` when the spill exceeds ``max_outliers``
        (default ``max(4096, nnz // 100)``) — the pattern is then not
        "banded plus a few couplings" and other layouts should serve it.
        """
        if max_outliers is None:
            max_outliers = max(4096, m.nnz // 100)
        rows = np.asarray(m.row_ids, np.int64)
        cols = np.asarray(m.indices, np.int64)
        data = np.asarray(m.data)
        offs = cols - rows
        uniq, inv, counts = np.unique(offs, return_inverse=True,
                                      return_counts=True)
        # keep an offset as a band only when it EARNS its full n-length
        # stream (ops.optimize.band_min_count); without this floor, sparse
        # junk offsets (1-2 entries each) fill the max_diags budget with
        # near-empty bands
        from .optimize import band_min_count

        min_count = band_min_count(m.shape[0], np.dtype(data.dtype).itemsize)
        order = np.argsort(counts)[::-1]
        order = order[counts[order] >= min_count][:max_diags]
        keep_ids = set(order.tolist())
        zero_pos = np.searchsorted(uniq, 0)
        if zero_pos < len(uniq) and uniq[zero_pos] == 0:
            keep_ids.add(int(zero_pos))
        keep_mask = np.isin(inv, np.fromiter(keep_ids, dtype=np.int64))
        n_out = int((~keep_mask).sum())
        if n_out > max_outliers:
            raise ValueError(
                f"hybrid split spills {n_out} entries (> {max_outliers}): "
                "no dominant band structure"
            )

        core_rows = rows[keep_mask]
        core_cols = cols[keep_mask]
        core_data = data[keep_mask]
        n = m.shape[0]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, core_rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        core_csr = CSR.from_arrays(
            core_data, core_cols.astype(np.int32), indptr, m.shape
        )
        core = DIA.from_csr(core_csr, max_diags=max(max_diags, len(keep_ids)))

        out_order = np.argsort(rows[~keep_mask], kind="stable")
        return HybridDIA(
            core=core,
            out_rows=jnp.asarray(rows[~keep_mask][out_order].astype(np.int32)),
            out_cols=jnp.asarray(cols[~keep_mask][out_order].astype(np.int32)),
            out_vals=jnp.asarray(data[~keep_mask][out_order]),
            shape=m.shape,
        )

    def matvec(self, x: jax.Array) -> jax.Array:
        y = self.core.matvec(x)
        if self.out_vals.shape[0] == 0:
            return y
        contrib = self.out_vals * jnp.take(x, self.out_cols)
        return y.at[self.out_rows].add(
            contrib, indices_are_sorted=True, unique_indices=False
        )

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: jax.Array) -> jax.Array:
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def diagonal(self) -> jax.Array:
        # offset 0 is pinned into the core by construction
        return self.core.diagonal()


jax.tree_util.register_dataclass(
    HybridDIA,
    data_fields=("core", "out_rows", "out_cols", "out_vals"),
    meta_fields=("shape",),
)
