"""Reordered operator: solve P·A·Pᵀ in a fast layout, permute at the edges.

The composition half of the inspector-executor story (the analog of MKL's
``mkl_sparse_optimize`` picking an internal representation,
``src/mkl_mat.rs:112-148``): when a general matrix is banded *after* RCM,
``optimize()`` wraps the fast banded operator in :class:`Reordered` so the
caller still sees the original row/column order.  The permutations run once
per solve at the vector boundary (``pad_vec``/``unpad_vec``), never inside
the iteration.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Reordered:
    """Wraps an operator built from A' = A[perm, perm].

    ``pad_vec`` maps an original-order vector into the inner layout
    (permute, then the inner operator's own ``pad_vec`` if it has one);
    ``unpad_vec`` inverts it.  ``matvec``/
    ``matvec_dot``/``jacobi_precond`` delegate to the inner operator —
    inside the solver iteration everything is in permuted layout.

    ``perm``/``inv_perm`` are pytree data (int32 device arrays): hashing a
    million-entry static tuple on every jit dispatch would dominate.
    """

    inner: object
    perm: jax.Array       # (n,) int32: permuted row i holds original row perm[i]
    inv_perm: jax.Array   # (n,) int32 inverse

    @staticmethod
    def wrap(inner, perm) -> "Reordered":
        perm = np.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        return Reordered(
            inner=inner,
            perm=jnp.asarray(perm.astype(np.int32)),
            inv_perm=jnp.asarray(inv.astype(np.int32)),
        )

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    def pad_vec(self, x: jax.Array) -> jax.Array:
        xp = jnp.take(jnp.asarray(x), self.perm, axis=0)
        # the inner operator may itself be Reordered (optimize() of an
        # already-permuted matrix)
        return self.inner.pad_vec(xp) if hasattr(self.inner, "pad_vec") else xp

    def unpad_vec(self, x2: jax.Array) -> jax.Array:
        x = self.inner.unpad_vec(x2) if hasattr(self.inner, "pad_vec") else x2
        return jnp.take(x, self.inv_perm, axis=0)

    def matvec(self, x2: jax.Array) -> jax.Array:
        return self.inner.matvec(x2)

    def matvec_dot(self, x2: jax.Array):
        return self.inner.matvec_dot(x2)

    def jacobi_precond(self):
        if hasattr(self.inner, "jacobi_precond"):
            return self.inner.jacobi_precond()
        # flat-layout inner (DIA/ELL): build from its diagonal directly
        from ..precond import DiagPrecond

        d = self.inner.diagonal()
        safe = jnp.where(d == 0, jnp.ones((), d.dtype), d)
        return DiagPrecond(diag_inv=jnp.ones((), d.dtype) / safe)

    def relay_diag_precond(self, M):
        """Permute the diagonal with the rows, then re-lay for the inner op."""
        from ..precond import DiagPrecond

        di = jnp.take(jnp.asarray(M.diag_inv), self.perm, axis=0)
        Mp = DiagPrecond(diag_inv=di)
        if hasattr(self.inner, "relay_diag_precond"):
            return self.inner.relay_diag_precond(Mp)
        return Mp

    def diagonal(self) -> jax.Array:
        # diagonal in ORIGINAL order (the diagonal is permutation-covariant)
        d = self.inner.diagonal()
        return jnp.take(d, self.inv_perm, axis=0)


jax.tree_util.register_dataclass(
    Reordered, data_fields=("inner", "perm", "inv_perm"), meta_fields=()
)
