"""The LinearOperator protocol — the analog of the reference's
``MatVecMul`` trait (``src/mat.rs:12-37``).

Anything with ``shape``, ``dtype``, ``matvec(x)`` and ``matvec_dot(x)`` is an
operator: the sparse containers, the preconditioners, and the distributed
row-partitioned wrappers all satisfy it, so every solver is generic over the
operator exactly as the reference solvers are generic over ``M: MatVecMul<T>``.

There is no "unchecked" variant: dimension checks happen at trace time against
static shapes (the checked/unchecked split is a bounds-check-elision idiom that
has no XLA counterpart).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple, runtime_checkable

import jax
import jax.numpy as jnp


@runtime_checkable
class LinearOperator(Protocol):
    shape: Tuple[int, int]

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A·x (reference ``mul_vec``)."""
        ...

    def matvec_dot(self, x: jax.Array):
        """(A·x, conj(x)·A·x) — fused SpMV+dot, mirrors ``mkl_sparse_?_dotmv``
        (``src/mat.rs:19-22``). XLA fuses the dot into the SpMV pass."""
        ...


def mv_conj_dot(A, x: jax.Array, axis_name=None):
    """(y = A·conj(x), conj(x)·y) — the CS-MINRES Saunders step
    (``src/cs_minres.rs:99-103``).  The dot is the *unconjugated* product of
    conj(x) with y, which equals ``conj_dot(x, y)``; XLA fuses the
    conjugation into the SpMV's input and the dot into its output pass."""
    from ..vecalg import conj, conj_dot

    y = A.matvec(conj(x))
    return y, conj_dot(x, y, axis_name)


def mv_wdot(A, x: jax.Array, w: jax.Array, axis_name=None):
    """(y = A·x, conj(w)·y); ``axis_name`` makes the dot collective,
    matching :func:`~sprsolve_tpu.vecalg.conj_dot`."""
    from ..vecalg import conj_dot

    y = A.matvec(x)
    return y, conj_dot(w, y, axis_name)


def mv_prec_wdot(A, M, x: jax.Array, w: jax.Array, axis_name=None):
    """(u = M⁻¹·x, y = A·u, conj(w)·y) — BiCGStab's first half."""
    u = M.matvec(x)
    y, wd = mv_wdot(A, u, w, axis_name)
    return u, y, wd


def mv_prec_wdot2(A, M, x: jax.Array, w: jax.Array, axis_name=None):
    """(u = M⁻¹·x, y = A·u, conj(w)·y, conj(y)·y) — the second-half variant
    of :func:`mv_prec_wdot`."""
    u = M.matvec(x)
    y, wd, yd = mv_wdot2(A, u, w, axis_name)
    return u, y, wd, yd


def mv_wdot2(A, x: jax.Array, w: jax.Array, axis_name=None):
    """(y = A·x, conj(w)·y, conj(y)·y) — both of BiCGStab's post-SpMV
    reductions."""
    from ..vecalg import conj_dot

    y = A.matvec(x)
    return y, conj_dot(w, y, axis_name), conj_dot(y, y, axis_name)


@dataclasses.dataclass(frozen=True)
class IdentityOperator:
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x: jax.Array) -> jax.Array:
        return x

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        return x, conj_dot(x, x)


jax.tree_util.register_dataclass(IdentityOperator, data_fields=(), meta_fields=("n",))


@dataclasses.dataclass(frozen=True)
class DiagonalOperator:
    """y = diag ⊙ x. Also the apply-form of the diagonal preconditioner."""

    diag: jax.Array

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    def matvec(self, x: jax.Array) -> jax.Array:
        return x * self.diag

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = x * self.diag
        return y, conj_dot(x, y)


jax.tree_util.register_dataclass(DiagonalOperator, data_fields=("diag",), meta_fields=())


def as_operator(a) -> LinearOperator:
    """Coerce common inputs (containers, dense arrays) to an operator."""
    if hasattr(a, "matvec"):
        return a
    arr = jnp.asarray(a)
    if arr.ndim == 2:
        return _DenseOperator(arr)
    raise TypeError(f"cannot interpret {type(a)} as a LinearOperator")


@dataclasses.dataclass(frozen=True)
class _DenseOperator:
    a: jax.Array

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    # HIGHEST: a default-precision f32 matmul may run in TF32 (~3 decimal
    # digits), and a solver's matvec must be exact to the working dtype
    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.matmul(self.a, x, precision=jax.lax.Precision.HIGHEST)

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)


jax.tree_util.register_dataclass(_DenseOperator, data_fields=("a",), meta_fields=())


@dataclasses.dataclass(frozen=True)
class ShiftedOperator:
    """y = A·x − shift·x, without materializing A − shift·I.

    Wraps any operator; the shift rides the same pass as the SpMV (XLA fuses
    the axpy into the operator's output write).  Enables spectral
    transformations — ``scipy.sparse.linalg.minres(..., shift=σ)`` parity,
    shift-invert-style eigencomputations, Helmholtz-like A − σI solves —
    for every execution layout (the wrapper forwards ``pad_vec``/
    ``unpad_vec`` so a shifted ``Reordered`` operator still runs in its
    permuted layout; build Jacobi preconditioners from ``diagonal()``, which
    includes the shift).
    """

    A: object
    shift: jax.Array  # scalar

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return getattr(self.A, "dtype", None)

    def matvec(self, x: jax.Array) -> jax.Array:
        return self.A.matvec(x) - self.shift * x

    def matvec_dot(self, x: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: jax.Array) -> jax.Array:
        if hasattr(self.A, "matmat"):
            return self.A.matmat(X) - self.shift * X
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    # forward the internal-layout protocol so shifted reordered operators
    # keep solving in their permuted layout
    def __getattr__(self, name):
        if name in ("pad_vec", "unpad_vec"):
            return getattr(self.A, name)
        raise AttributeError(name)

    def diagonal(self) -> jax.Array:
        """Flat shifted diagonal."""
        return self.A.diagonal() - self.shift

    def jacobi_precond(self):
        """Jacobi preconditioner of the *shifted* operator: 1/(diag(A) − σ),
        re-laid into the inner operator's internal layout when it has one
        (the path solve(..., M='jacobi') takes for reordered operators)."""
        from ..precond import DiagPrecond

        M = DiagPrecond.new(self.diagonal())
        if hasattr(self.A, "relay_diag_precond"):
            return self.A.relay_diag_precond(M)
        return M

    def relay_diag_precond(self, M):
        if hasattr(self.A, "relay_diag_precond"):
            return self.A.relay_diag_precond(M)
        raise NotImplementedError(
            "inner operator has no internal-layout diagonal relay"
        )


jax.tree_util.register_dataclass(
    ShiftedOperator, data_fields=("A", "shift"), meta_fields=()
)
