"""Debug module: the operator checker."""

import jax.numpy as jnp
import numpy as np
import pytest

import sprsolve_tpu as sp
from sprsolve_tpu import debug
from sprsolve_tpu.utils import problems


def test_check_operator_passes_for_valid_ops():
    A = problems.grid_laplacian_dirichlet((10, 10))
    x = jnp.zeros(100)
    assert debug.check_operator(A, x)
    assert debug.check_operator(A.to_dia(), x)
    assert debug.check_operator(A.to_ell(), x)
    assert debug.check_operator(sp.BSR.from_csr(A, bs=32), x)


def test_check_operator_complex():
    A, _ = problems.hermitian_grid((6, 6))
    assert debug.check_operator(A, jnp.zeros(36, jnp.complex128))


def test_check_operator_catches_nonlinear():
    class Bad:
        shape = (4, 4)

        def matvec(self, x):
            return x * x  # not linear

        def matvec_dot(self, x):
            y = self.matvec(x)
            return y, jnp.vdot(x, y)

    with pytest.raises(AssertionError):
        debug.check_operator(Bad(), jnp.zeros(4))


def test_check_operator_reordered_layout():
    """check_operator takes the operator's own vector layout (a permuted
    Reordered operator checked on a pad_vec example)."""
    from sprsolve_tpu.ops.reordered import Reordered

    A = problems.grid_laplacian_dirichlet((16, 16))
    op = Reordered.wrap(A.to_dia(), np.random.default_rng(0).permutation(256))
    assert debug.check_operator(op, op.pad_vec(jnp.zeros(256)))
