"""Solver status codes and host-level exceptions.

Mirrors the reference error model (``src/error.rs:3-22`` in sprsolve): the
reference returns ``SolveResult<(usize, T::Real)>`` where the error enum is
{IncompatibleMatrixFormat, ZeorDiagonalElem, InsufficientIterNum, BreakDown,
InvalidPreconditioner}.

Design: solves run inside ``jax.lax.while_loop``; early returns are
impossible under XLA, so termination reasons are carried through the loop state
as an integer *status code* and surfaced after the loop.  The functional API
returns a :class:`SolveInfo`; the object API (``sprsolve_tpu.api``) converts a
non-converged status into the matching Python exception, which is what a user
of the reference's ``.unwrap()`` behavior expects.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Status(enum.IntEnum):
    """Termination status of an iterative solve.

    ``RUNNING`` only ever appears inside the while_loop carry; a returned
    SolveInfo always holds one of the other values.
    """

    RUNNING = -1
    CONVERGED = 0
    INSUFFICIENT_ITER = 1   # reference: SolverError::InsufficientIterNum
    BREAKDOWN = 2           # reference: SolverError::BreakDown
    INVALID_PRECONDITIONER = 3  # reference: SolverError::InvalidPreconditioner
    ZERO_DIAGONAL = 4       # reference: SolverError::ZeorDiagonalElem (sic)
    INCOMPATIBLE_FORMAT = 5  # reference: SolverError::IncompatibleMatrixFormat


class SolverError(Exception):
    """Base class mirroring the reference ``SolverError`` enum."""


class IncompatibleMatrixFormat(SolverError):
    pass


class ZeroDiagonalElem(SolverError):
    pass


class InsufficientIterNum(SolverError):
    pass


class BreakDown(SolverError):
    pass


class InvalidPreconditioner(SolverError):
    pass


_STATUS_TO_EXC = {
    int(Status.INSUFFICIENT_ITER): InsufficientIterNum,
    int(Status.BREAKDOWN): BreakDown,
    int(Status.INVALID_PRECONDITIONER): InvalidPreconditioner,
    int(Status.ZERO_DIAGONAL): ZeroDiagonalElem,
    int(Status.INCOMPATIBLE_FORMAT): IncompatibleMatrixFormat,
}


class SolveInfo(NamedTuple):
    """Observable outcome of a solve.

    The reference returns ``(iterations, residual)`` on success
    (``src/bicg_stab.rs:41``); we additionally carry the termination status so
    the result is a plain pytree that can cross the jit boundary.
    ``residual`` follows each solver's own convention (relative for the Krylov
    solvers, absolute for Gauss-Seidel — ``src/gauss_seidel.rs:107``).
    """

    iterations: jax.Array  # int32 scalar
    residual: jax.Array    # real scalar
    status: jax.Array      # int32 scalar, one of Status

    @property
    def converged(self) -> jax.Array:
        return self.status == Status.CONVERGED

    def raise_if_error(self) -> "SolveInfo":
        """Host-side check: raise the exception matching a failure status.

        This is the analog of ``.unwrap()`` on the reference's SolveResult.
        Forces a device sync.
        """
        code = int(self.status)
        if code == int(Status.CONVERGED):
            return self
        exc = _STATUS_TO_EXC.get(code, SolverError)
        raise exc(
            f"solver failed with status {Status(code).name} after "
            f"{int(self.iterations)} iterations (residual {float(self.residual):.3e})"
        )


def running_status() -> jax.Array:
    return jnp.int32(Status.RUNNING)
