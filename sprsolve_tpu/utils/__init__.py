"""Utilities: test/bench problem generators and timing harness."""

from . import timing
from .io import mmread, mmwrite
from .problems import (
    grid_laplacian_dirichlet,
    set_boundary_condition,
    sym_grid_laplacian,
    simple_diag_system,
    hermitian_grid,
    hermitian_grid_with_diag,
    complex_symmetric_grid_with_diag,
    poisson3d,
)

__all__ = [
    "mmread",
    "mmwrite",
    "grid_laplacian_dirichlet",
    "set_boundary_condition",
    "sym_grid_laplacian",
    "simple_diag_system",
    "hermitian_grid",
    "hermitian_grid_with_diag",
    "complex_symmetric_grid_with_diag",
    "poisson3d",
]
