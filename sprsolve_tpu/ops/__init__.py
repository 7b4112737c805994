"""Compute kernels: SpMV implementations and the LinearOperator protocol."""

from .operator import (
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
    ShiftedOperator,
    as_operator,
)
from .optimize import optimize
from .spmv import spmv_coo, spmv_csr, spmv_ell, spmv_dia

__all__ = [
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "ShiftedOperator",
    "as_operator",
    "optimize",
    "spmv_coo",
    "spmv_csr",
    "spmv_ell",
    "spmv_dia",
]
