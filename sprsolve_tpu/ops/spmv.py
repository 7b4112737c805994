"""SpMV implementations (pure XLA paths).

Replaces the reference's CSR row-loop SpMV (``src/mat.rs:68-143``, rayon
threads) and MKL sparse mv/dotmv (``src/mkl_mat.rs:170-319``).  The
parallelism is expressed as whole-array ops that XLA fuses into kernels:

- ``spmv_coo`` / ``spmv_csr``: gather x at column indices, multiply, row-wise
  segment-sum. Static shapes, fully general. The correctness oracle.
- ``spmv_ell``: (n, k) regular layout — gather + row reduction, no segment
  machinery; XLA fuses it into one pass.
- ``spmv_dia``: banded fast path — every x access is a contiguous shifted
  slice (zero irregular access; speed-of-light for stencils).  XLA fuses
  all bands into one pass; the card's L2 serves the shifted re-reads of x.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..sparse.containers import COO, CSR, ELL, DIA


def spmv_coo(m: COO, x: jax.Array) -> jax.Array:
    """y = A·x for COO. Rows with no entries produce 0 (matches the reference
    zero-init at ``src/mat.rs:71``)."""
    contrib = m.data * jnp.take(x, m.col, indices_are_sorted=False)
    return jax.ops.segment_sum(
        contrib, m.row, num_segments=m.shape[0], indices_are_sorted=False
    )


def spmv_csr(m: CSR, x: jax.Array) -> jax.Array:
    """y = A·x for CSR via its flat row_ids (sorted-COO) companion arrays."""
    contrib = m.data * jnp.take(x, m.indices, indices_are_sorted=False)
    return jax.ops.segment_sum(
        contrib, m.row_ids, num_segments=m.shape[0], indices_are_sorted=True
    )


def spmv_ell(m: ELL, x: jax.Array) -> jax.Array:
    """y = A·x for ELL: (n, k) gather then reduce over the k slots."""
    gathered = jnp.take(x, m.cols, axis=0)  # (n, k)
    return jnp.sum(m.data * gathered, axis=1)


def spmm_csr(m: CSR, X: jax.Array) -> jax.Array:
    """Y = A·X for CSR with X of shape (n, k) — multi-RHS SpMM."""
    contrib = m.data[:, None] * jnp.take(X, m.indices, axis=0)
    return jax.ops.segment_sum(
        contrib, m.row_ids, num_segments=m.shape[0], indices_are_sorted=True
    )


def spmm_ell(m: ELL, X: jax.Array) -> jax.Array:
    """Y = A·X for ELL: (n, k_slots, rhs) gather then reduce over slots."""
    gathered = jnp.take(X, m.cols, axis=0)  # (n, k_slots, rhs)
    return jnp.sum(m.data[:, :, None] * gathered, axis=1)


def spmm_dia(m: DIA, X: jax.Array) -> jax.Array:
    """Y = A·X for DIA: shifted contiguous row-blocks of X, no gathers."""
    n = m.shape[0]
    k = X.shape[1]
    Y = jnp.zeros((n, k), dtype=jnp.result_type(m.dtype, X.dtype))
    pad = lambda rows: jnp.zeros((rows, k), dtype=X.dtype)
    for d, off in enumerate(m.offsets):
        if off == 0:
            shifted = X
        elif off > 0:
            shifted = jnp.concatenate([X[off:], pad(off)])
        else:
            shifted = jnp.concatenate([pad(-off), X[:off]])
        Y = Y + m.bands[d].astype(Y.dtype)[:, None] * shifted
    return Y


def spmv_dia(m: DIA, x: jax.Array) -> jax.Array:
    """y = A·x for DIA: y[i] = Σ_d bands[d, i] · x[i + off_d].

    Each shifted x is built with pad+slice (contiguous, no gather). The Python
    loop over the (static, few) offsets unrolls at trace time and XLA fuses the
    whole thing into a single pass over n; narrow band storage
    (:meth:`DIA.narrow`) is widened inside that pass.
    """
    n = m.shape[0]
    y = jnp.zeros(n, dtype=jnp.result_type(m.dtype, x.dtype))
    for d, off in enumerate(m.offsets):
        if off == 0:
            shifted = x
        elif off > 0:
            # x[i + off] for i in [0, n-off); zero beyond
            shifted = jnp.concatenate([x[off:], jnp.zeros(off, dtype=x.dtype)])
        else:
            shifted = jnp.concatenate([jnp.zeros(-off, dtype=x.dtype), x[:off]])
        y = y + m.bands[d].astype(y.dtype) * shifted
    return y
