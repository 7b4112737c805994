"""Multi-chip distribution: row-partitioned operators over a device mesh.

The reference has **no** distributed runtime (SURVEY.md §2: rayon threads and
MKL's internal threading are the complete parallelism story).  This package is
the scaling layer BASELINE.md requires: the matrix is partitioned by row
blocks across a 1-D ``jax.sharding.Mesh``, each device owns the matching
block of every solver vector, Krylov inner products become ``psum``
collectives, and the SpMV obtains remote x entries via halo exchange
(all-gather v1; neighbor ``ppermute`` overlapped with local compute for banded
operators).

Because every solver already threads an ``axis_name`` through its reductions
(see ``vecalg.py``), the *same* solver code runs single-chip and under
``shard_map`` — distribution is purely an operator + data-layout concern.
"""

from . import multihost
from .dist_operator import (
    AllGatherELL, HaloDIA, MPKDIA, partition_csr, partition_dia,
    partition_dia_mpk,
)
from .eigen import (
    distributed_lobpcg,
    distributed_rational_filter_eigs,
    distributed_shift_invert_eigs,
)
from .solve import distributed_solve, make_solver_specs

__all__ = [
    "AllGatherELL",
    "HaloDIA",
    "partition_csr",
    "partition_dia",
    "MPKDIA",
    "partition_dia_mpk",
    "distributed_solve",
    "distributed_lobpcg",
    "distributed_rational_filter_eigs",
    "distributed_shift_invert_eigs",
    "make_solver_specs",
    "multihost",
]
