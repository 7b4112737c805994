"""Shared solver plumbing: early-out wrappers and info construction."""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import SolveInfo, Status
from ..vecalg import eps_for, norm2


def make_info(iterations, residual, status) -> SolveInfo:
    return SolveInfo(
        iterations=jnp.asarray(iterations, dtype=jnp.int32),
        residual=residual,
        status=jnp.asarray(status, dtype=jnp.int32),
    )


def with_zero_rhs_guard(
    b: jax.Array,
    x0: jax.Array,
    main: Callable[[jax.Array], tuple],
    axis_name: Optional[str] = None,
):
    """Reference early-out: if ‖b‖ ≤ ε, return x = 0 with Ok((0, ‖b‖))
    (``src/bicg_stab.rs:56-60`` and identically in every other solver).

    ``main`` receives ``rhs_norm`` and must return ``(x, SolveInfo)``.
    """
    rhs_norm = norm2(b, axis_name)
    eps = eps_for(b.dtype)

    def trivial(_):
        zero_x = jnp.zeros_like(x0)
        return zero_x, make_info(0, rhs_norm, Status.CONVERGED)

    return lax.cond(rhs_norm <= eps, trivial, lambda _: main(rhs_norm), None)


def check_shapes(A, b, x0, axis_name=None):
    """Trace-time dimension checks — the analog of the reference's
    IncompatibleMatrixFormat returns (``src/bicg_stab.rs:44-53``). Shapes are
    static under XLA, so these raise eagerly in Python.

    Under shard_map (``axis_name`` set) the operator carries its *global*
    shape while b/x are per-device row blocks, so only the vector shapes are
    compared against each other (scaled by the axis size at trace time).
    """
    from ..errors import IncompatibleMatrixFormat

    n = b.shape[0]
    # flat vectors are checked against the operator; 2-D multi-RHS blocks
    # only against each other.
    if b.ndim == 1 and hasattr(A, "shape") and A.shape is not None:
        n_global = n if axis_name is None else n * lax.axis_size(axis_name)
        if A.shape[1] != n_global:
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
    if x0.shape != b.shape:
        raise IncompatibleMatrixFormat(
            "Input and output vec dimension do not match"
        )
