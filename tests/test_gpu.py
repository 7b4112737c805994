"""Tests that need an NVIDIA GPU (marker ``gpu``).  They skip elsewhere via
the ``gpu_device`` fixture; on a card run
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``."""

import jax.numpy as jnp
import numpy as np
import pytest

import sprsolve_tpu as sp
from sprsolve_tpu.utils import problems

pytestmark = pytest.mark.gpu


def test_banded_solve_on_card(gpu_device):
    """optimize()'s narrow-band DIA and a BiCGStab + Jacobi solve compiled
    for the card, checked on the host in f64."""
    A = problems.poisson3d(32, 32, 32, dtype=np.float32)
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    op = sp.optimize(A)
    assert op.bands.dtype == jnp.int8
    x, info = sp.solve(A, b, method="bicgstab", M="jacobi", tol=1e-6,
                       max_iter=2000)
    info.raise_if_error()
    assert x.devices() == {gpu_device}
    r = A.matvec(np.asarray(x, np.float64)) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-5


def test_complex_solve_on_card(gpu_device):
    """c64 crosses the jit boundary natively on the card (COCG)."""
    A, rhs, _ = problems.complex_symmetric_grid_with_diag(
        (32, 32), dtype=np.complex64
    )
    x, info = sp.solve(A, rhs.astype(np.complex64), method="cocg",
                       M="jacobi", tol=1e-5, max_iter=2000)
    info.raise_if_error()
    assert x.dtype == jnp.complex64 and x.devices() == {gpu_device}
