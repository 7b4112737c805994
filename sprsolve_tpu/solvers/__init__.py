"""Iterative solvers: Krylov (BiCGStab, MINRES, CS-MINRES) and stationary
(Gauss-Seidel), each expressed as a jittable pure function over a
``lax.while_loop`` state pytree."""

from .bicgstab import bicgstab
from .bicgstabl import bicgstabl
from .block_cg import batched, block_cg
from .ca_bicgstab import ca_bicgstab
from .ca_cg import ca_cg
from .cg import cg, cg_single_sync
from .fgmres import fgmres
from .gmres import gmres
from .idrs import idrs
from .lobpcg import lobpcg
from .lsqr import lsqr
from .minres import minres
from .tfqmr import tfqmr
from .refine import refine, refine_solve
from .cgs import cgs
from .cocg import cocg
from .eigs import InvertedOperator, shift_invert_eigs
from .rational import rational_filter_eigs
from .cs_minres import cs_minres
from .gauss_seidel import gauss_seidel
from .redblack import (
    ColoredELL,
    MaskedGSPrecond,
    MulticolorGSPrecond,
    color_masks,
    gauss_seidel_redblack,
    greedy_color,
)

__all__ = [
    "bicgstab",
    "bicgstabl",
    "batched",
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
    "refine",
    "refine_solve",
    "cgs",
    "tfqmr",
    "cocg",
    "cs_minres",
    "InvertedOperator",
    "shift_invert_eigs",
    "rational_filter_eigs",
    "gauss_seidel",
    "gauss_seidel_redblack",
    "ColoredELL",
    "MulticolorGSPrecond",
    "MaskedGSPrecond",
    "color_masks",
    "greedy_color",
]
