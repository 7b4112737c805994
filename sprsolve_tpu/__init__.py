"""sprsolve_tpu — sparse iterative linear solvers on JAX/XLA.

A from-scratch JAX framework with the capabilities of the ``sprsolve`` Rust
crate (BiCGStab, MINRES, CS-MINRES, Gauss-Seidel over CSR/COO/ELL/DIA sparse
matrices, f32/f64/c64/c128, diagonal preconditioning), re-designed for an
accelerator: solvers are jittable ``lax.while_loop`` programs over operator
pytrees, SpMV executes in regular DIA/BSR/ELL layouts that XLA fuses, and
multi-device scaling uses row-partitioned operators under ``shard_map`` with
psum inner products and halo exchange.

Public surface mirrors the reference re-exports (``src/lib.rs:15-21``).
"""

from . import debug, errors, multigrid, precond, vecalg
from .api import CG, GMRES, BiCGStab, CSMinRes, GaussSeidel, MinRes, PreparedSolver, prepare, solve
from .errors import SolveInfo, SolverError, Status
from .ops.operator import (
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
    ShiftedOperator,
)
from .ops.hybrid import HybridDIA
from .ops.optimize import optimize
from .multigrid import GridMGPrecond
from .precond import (
    BlockJacobiPrecond,
    ChebyshevPrecond,
    DiagPrecond,
    estimate_spectral_bounds,
    IC0Precond,
    ILU0Precond,
    InnerSolvePrecond,
    RelayedPrecond,
)
from .utils.bounds import gershgorin_bounds
from .solvers import (
    ColoredELL,
    MaskedGSPrecond,
    MulticolorGSPrecond,
    batched,
    bicgstab,
    bicgstabl,
    block_cg,
    color_masks,
    cg,
    cg_single_sync,
    ca_bicgstab,
    ca_cg,
    cgs,
    cocg,
    cs_minres,
    rational_filter_eigs,
    shift_invert_eigs,
    fgmres,
    gauss_seidel,
    gauss_seidel_redblack,
    gmres,
    idrs,
    lobpcg,
    lsqr,
    greedy_color,
    minres,
    tfqmr,
    refine,
    refine_solve,
)
from .sparse import BSR, ComplexBSR, COO, CSC, CSR, DIA, ELL, csr_from_bcoo, csr_from_dense, csr_from_scipy, reorder_rcm

__version__ = "0.1.0"

__all__ = [
    "solve",
    "prepare",
    "PreparedSolver",
    "BiCGStab",
    "CG",
    "GMRES",
    "MinRes",
    "CSMinRes",
    "GaussSeidel",
    "batched",
    "bicgstab",
    "block_cg",
    "cg",
    "cg_single_sync",
    "ca_bicgstab",
    "ca_cg",
    "fgmres",
    "gmres",
    "idrs",
    "lobpcg",
    "lsqr",
    "minres",
    "tfqmr",
    "refine",
    "refine_solve",
    "bicgstabl",
    "cgs",
    "cocg",
    "rational_filter_eigs",
    "shift_invert_eigs",
    "cs_minres",
    "gauss_seidel",
    "gauss_seidel_redblack",
    "ColoredELL",
    "MulticolorGSPrecond",
    "MaskedGSPrecond",
    "color_masks",
    "greedy_color",
    "BSR",
    "ComplexBSR",
    "COO",
    "CSC",
    "CSR",
    "ELL",
    "DIA",
    "csr_from_dense",
    "csr_from_bcoo",
    "csr_from_scipy",
    "reorder_rcm",
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "ShiftedOperator",
    "DiagPrecond",
    "BlockJacobiPrecond",
    "GridMGPrecond",
    "ChebyshevPrecond",
    "estimate_spectral_bounds",
    "gershgorin_bounds",
    "ILU0Precond",
    "InnerSolvePrecond",
    "IC0Precond",
    "RelayedPrecond",
    "optimize",
    "HybridDIA",
    "SolveInfo",
    "SolverError",
    "Status",
    "debug",
    "errors",
    "precond",
    "vecalg",
]
