"""Distributed solve driver: shard_map a solver over a row-partitioned system.

The solver functions themselves are mesh-agnostic — they thread an
``axis_name`` through every reduction (``vecalg``), so this driver only has to
lay out the data: pad n to the mesh size, shard the operator / rhs / guess by
row blocks, run the solver inside ``shard_map`` (inner products become psum,
SpMV does its halo exchange), and unpad.  SolveInfo comes back replicated.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..errors import SolveInfo
from ..precond import DiagPrecond
from ..sparse.containers import CSR, DIA
from .dist_operator import (
    AllGatherELL, HaloDIA, MPKDIA, auto_mesh, partition_csr, partition_dia,
    partition_dia_mpk,
)


def make_solver_specs(A_parts, M_parts, axis_name: str):
    """(in_specs, out_specs) for shard_map'ing solver(A, b, x0[, M])."""
    a_spec = A_parts.pspec(axis_name)
    specs = [a_spec, P(axis_name), P(axis_name)]
    if M_parts is not None:
        if hasattr(M_parts, "pspec"):
            specs.append(M_parts.pspec(axis_name))
        else:
            specs.append(jax.tree.map(lambda _: P(axis_name), M_parts))
    out_specs = (P(axis_name), SolveInfo(P(), P(), P()))
    return tuple(specs), out_specs


def distributed_solve(
    solver_fn,
    A,
    b,
    x0: Optional[jax.Array] = None,
    *,
    M=None,
    tol,
    max_iter,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    mpk_s: Optional[int] = None,
):
    """Solve A·x = b with ``solver_fn`` row-partitioned over ``mesh``.

    ``A`` may be a host CSR/DIA container (partitioned here) or an already
    partitioned :class:`AllGatherELL` / :class:`HaloDIA`.  ``M`` (optional)
    must be a :class:`DiagPrecond`; its diagonal is sharded with the rows.
    Returns the global ``(x, SolveInfo)``.

    ``mpk_s``: partition a host DIA with matrix-powers band windows
    (:class:`MPKDIA`, depth ``mpk_s``) so an s-step solver — pass
    ``functools.partial(ca_cg, s=..., bounds=...)`` as ``solver_fn`` —
    amortizes its halo exchanges.
    """
    mesh = auto_mesh(mesh, axis_name)
    n_dev = mesh.shape[axis_name]

    if isinstance(A, CSR):
        if mpk_s:
            raise TypeError(
                "matrix-powers partitioning (mpk_s) needs a banded DIA "
                "operator; convert with A.to_dia()"
            )
        A_parts = partition_csr(A, n_dev, axis_name)
    elif isinstance(A, DIA):
        A_parts = (
            partition_dia_mpk(A, n_dev, mpk_s, axis_name)
            if mpk_s else partition_dia(A, n_dev, axis_name)
        )
    elif isinstance(A, (AllGatherELL, HaloDIA, MPKDIA)):
        A_parts = A
    else:
        raise TypeError(f"cannot partition operator of type {type(A)}")

    n = b.shape[0]
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    n_pad = A_parts.shape[0]
    if n_pad != n:
        # rhs may be (n,) or an (n, k) multi-rhs block (block_cg)
        pad = jnp.zeros((n_pad - n,) + b.shape[1:], dtype=b.dtype)
        b = jnp.concatenate([b, pad])
        x0 = jnp.concatenate([x0, pad])

    M_parts = None
    if M is not None:
        from ..precond import ComplexDiagPrecond

        if isinstance(M, ComplexDiagPrecond):
            # complex Jacobi planes shard with the rows; pad slots get the
            # inert 1 + 0i reciprocal
            ir, ii = M.inv_re, M.inv_im
            if ir.shape[0] != n_pad:
                ir = jnp.concatenate(
                    [ir, jnp.ones(n_pad - ir.shape[0], ir.dtype)]
                )
                ii = jnp.concatenate(
                    [ii, jnp.zeros(n_pad - ii.shape[0], ii.dtype)]
                )
            M_parts = ComplexDiagPrecond(inv_re=ir, inv_im=ii)
        elif isinstance(M, DiagPrecond):
            di = M.diag_inv
            if di.shape[0] != n_pad:
                di = jnp.concatenate(
                    [di, jnp.ones(n_pad - di.shape[0], dtype=di.dtype)]
                )
            M_parts = DiagPrecond(diag_inv=di)
        elif hasattr(M, "pspec"):
            # operator preconditioners (e.g. MaskedGSPrecond over a
            # distributed operator) supply their own partition specs; the
            # caller is responsible for building them in distributed layout
            M_parts = M
        else:
            raise TypeError(
                "distributed_solve supports DiagPrecond or pspec-capable "
                "operator preconditioners"
            )

    in_specs, out_specs = make_solver_specs(A_parts, M_parts, axis_name)

    if jax.process_count() > 1:
        # multi-host: shard_map needs globally-sharded jax.Arrays (each
        # process holds only its addressable row blocks); host numpy inputs
        # are placed per-leaf according to the same in_specs
        from .multihost import host_to_global

        def _place(leaf, spec):
            if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
                return leaf  # already global
            return host_to_global(leaf, mesh, spec)

        if M_parts is None:
            (A_parts, b, x0) = jax.tree.map(
                _place, (A_parts, b, x0), tuple(in_specs)
            )
        else:
            (A_parts, b, x0, M_parts) = jax.tree.map(
                _place, (A_parts, b, x0, M_parts), tuple(in_specs)
            )

    if M_parts is None:

        def run(A_, b_, x_):
            return solver_fn(
                A_, b_, x_, tol=tol, max_iter=max_iter, axis_name=axis_name
            )

        args = (A_parts, b, x0)
    else:

        def run(A_, b_, x_, M_):
            return solver_fn(
                A_, b_, x_, M=M_, tol=tol, max_iter=max_iter, axis_name=axis_name
            )

        args = (A_parts, b, x0, M_parts)

    # check_vma=False: some solvers' while_loop carries (idrs; fgmres with
    # an inner solve) fail the varying-across-mesh type check; the data flow
    # is still fully sharded.
    sharded = jax.shard_map(
        run, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )
    x_pad, info = sharded(*args)
    # Replicate the solution before returning: downstream host-side use
    # (residual checks, slicing off the padding) on a row-sharded array would
    # hit gather-sharding ambiguities — and under multi-host the row-sharded
    # result is not even fully addressable. The solve itself ran fully
    # sharded; this is one all-gather at the end.
    from .multihost import replicate

    x_pad = replicate(x_pad, mesh)
    if n_pad != n:
        x_pad = x_pad[:n]
    return x_pad, info
