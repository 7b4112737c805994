"""MaskedGSPrecond: equivalence with the gathered ColoredELL sweep, and the
full BiCGStab + GS-preconditioner combination on optimize()'s narrow-band
DIA (BASELINE config #4's solver stack, miniature)."""


import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.solvers.redblack import ColoredELL
from sprsolve_tpu.utils import problems


def _dirichlet(shape):
    A = problems.grid_laplacian_dirichlet(shape)
    b = np.zeros(shape[0] * shape[1])
    problems.set_boundary_condition(b, shape, lambda r, c: float(r + c))
    return A, b


def test_masked_equals_colored_sweep():
    A, b = _dirichlet((8, 8))
    colors = sp.greedy_color(A)
    colored = ColoredELL.from_csr(A, colors)
    masks = sp.color_masks(colors)
    M_masked = sp.MaskedGSPrecond(
        A=A.to_dia(), diag=A.diagonal(), masks=masks, sweeps=1
    )
    r = jnp.asarray(np.random.default_rng(0).standard_normal(64))
    # one sweep from zero must match the gathered implementation exactly
    z_colored = colored.sweep(r, jnp.zeros_like(r))
    z_masked = M_masked.matvec(r)
    np.testing.assert_allclose(
        np.asarray(z_masked), np.asarray(z_colored), rtol=1e-14, atol=1e-14
    )


def test_masked_gs_precond_accelerates_bicgstab():
    A, b = _dirichlet((20, 20))
    colors = sp.greedy_color(A)
    M = sp.MaskedGSPrecond(
        A=A.to_dia(), diag=A.diagonal(), masks=sp.color_masks(colors), sweeps=2
    )
    x_p, info_p = sp.bicgstab(A, jnp.asarray(b), M=M, tol=1e-14, max_iter=1500)
    info_p.raise_if_error()
    x_j, info_j = sp.bicgstab(A, jnp.asarray(b), tol=1e-14, max_iter=1500)
    assert int(info_p.iterations) < int(info_j.iterations) // 2
    r = np.asarray(A.matvec(x_p)) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-11


def test_masked_gs_in_pallas_layout():
    """The whole stack — narrow-band DIA SpMV + masked-GS preconditioner +
    BiCGStab — in f32, as optimize() lays it out."""
    A, b = _dirichlet((16, 16))
    A32 = sp.CSR.from_arrays(np.asarray(A.data, np.float32), A.indices,
                             A.indptr, A.shape)
    op = sp.optimize(A32)
    assert op.bands.dtype == jnp.int8
    colors = sp.greedy_color(A)
    M = sp.MaskedGSPrecond(
        A=op, diag=op.diagonal(), masks=sp.color_masks(colors), sweeps=1
    )
    x, info = sp.bicgstab(op, jnp.asarray(b, jnp.float32), M=M, tol=1e-6,
                          max_iter=1500)
    info.raise_if_error()
    r = np.asarray(A.matvec(np.asarray(x, np.float64))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-5


def _spd_poisson(side=12):
    A, _ = problems.sym_grid_laplacian((side, side))
    return sp.csr_from_dense(-np.asarray(A.todense()))


def _materialize(M, n):
    cols = [np.asarray(M.matvec(jnp.zeros(n).at[i].set(1.0))) for i in range(n)]
    return np.stack(cols, axis=1)


def test_ssor_apply_is_symmetric_map():
    A = _spd_poisson(6)
    colors = sp.greedy_color(A)
    M = sp.MaskedGSPrecond(
        A=A.to_dia(), diag=A.diagonal(), masks=sp.color_masks(colors),
        sweeps=1, omega=1.3, symmetric=True,
    )
    dense = _materialize(M, 36)
    np.testing.assert_allclose(dense, dense.T, rtol=1e-12, atol=1e-13)
    # ... and positive definite for SPD A with 0 < omega < 2
    ev = np.linalg.eigvalsh((dense + dense.T) / 2)
    assert ev[0] > 0


def test_forward_omega_one_unchanged():
    # the omega/symmetric extension must not perturb the default map
    A, _ = _dirichlet((8, 8))
    colors = sp.greedy_color(A)
    masks = sp.color_masks(colors)
    M_new = sp.MaskedGSPrecond(A=A.to_dia(), diag=A.diagonal(), masks=masks)
    colored = ColoredELL.from_csr(A, colors)
    r = jnp.asarray(np.random.default_rng(3).standard_normal(64))
    np.testing.assert_allclose(
        np.asarray(M_new.matvec(r)),
        np.asarray(colored.sweep(r, jnp.zeros_like(r))),
        rtol=1e-14, atol=1e-14,
    )


def test_ssor_with_minres_and_cg():
    A = _spd_poisson(16)
    colors = sp.greedy_color(A)
    M = sp.MaskedGSPrecond(
        A=A.to_dia(), diag=A.diagonal(), masks=sp.color_masks(colors),
        sweeps=1, omega=1.5, symmetric=True,
    )
    b = jnp.asarray(np.random.default_rng(4).standard_normal(256))
    x_m, info_m = sp.minres(A.to_dia(), b, M=M, tol=1e-10, max_iter=2000)
    info_m.raise_if_error()  # symmetric apply passes the beta^2 gate
    _, info_0 = sp.minres(A.to_dia(), b, tol=1e-10, max_iter=2000)
    assert int(info_m.iterations) < int(info_0.iterations)
    x_c, info_c = sp.cg(A.to_dia(), b, M=M, tol=1e-10, max_iter=2000)
    info_c.raise_if_error()
    r = np.asarray(A.matvec(x_c)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-8
