"""BiCGStab(ℓ) — beyond the reference's surface (``src/bicg_stab.rs`` is
the ℓ=1 algorithm): dense-oracle cycle parity, convergence on symmetric /
nonsymmetric / complex systems, preconditioning, warm start, traces,
solve() routing, and the padded-kernel path."""

import jax
import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.errors import Status
from sprsolve_tpu.solvers import bicgstabl
from sprsolve_tpu.utils import problems


def _dirichlet(shape=(20, 20)):
    A = problems.grid_laplacian_dirichlet(shape)
    b = np.zeros(shape[0] * shape[1])
    problems.set_boundary_condition(b, shape, lambda r, c: float(r + c))
    return A, b


def _dense_bicgstabl_oracle(dense, b, l, tol, max_iter, Minv=None):
    """The same algorithm (right-preconditioned on the correction, shadow
    restart at the j-step boundary on a dead scalar), numpy left-to-right
    arithmetic. Returns (x, cycles) or (x, None)."""
    n = len(b)
    if Minv is None:
        Minv = np.ones(n)
    x0 = np.zeros(n, dense.dtype)
    r = b - dense @ x0
    # scalar-death floor, mirroring the solver's (eps*||r0||)^2 convention
    brk = (np.linalg.norm(r) * np.finfo(dense.dtype).eps) ** 2
    rt = r.copy()
    z = np.zeros(n, dense.dtype)
    u = np.zeros(n, dense.dtype)
    rho0, alpha, omega = 1.0, 0.0, 1.0
    bnorm = np.linalg.norm(b)
    K = lambda v: dense @ (Minv * v)
    rcount = 0
    for cyc in range(max_iter):
        if np.linalg.norm(r) <= tol * bnorm:
            return x0 + Minv * z, cyc
        rho0 = -omega * rho0
        rs = [r] + [None] * l
        us = [u] + [None] * l
        z_c = z
        rho1 = np.vdot(rt, rs[0])
        dead = False
        for j in range(l):
            if abs(rho0) <= brk:
                dead = True
                break
            beta = alpha * rho1 / rho0
            rho0 = rho1
            us_n = [rs[i] - beta * us[i] for i in range(j + 1)]
            u_next = K(us_n[j])
            gamma = np.vdot(rt, u_next)
            if abs(gamma) <= brk:
                dead = True
                break
            alpha = rho0 / gamma
            for i in range(j + 1):
                us[i] = us_n[i]
            us[j + 1] = u_next
            for i in range(j + 1):
                rs[i] = rs[i] - alpha * us[i + 1]
            rs[j + 1] = K(rs[j])
            rho1 = np.vdot(rt, rs[j + 1])
            z_c = z_c + alpha * us[0]
        if not dead:
            tau = [[None] * (l + 1) for _ in range(l + 1)]
            sigma = [None] * (l + 1)
            gamma_p = [None] * (l + 1)
            for j in range(1, l + 1):
                for i in range(1, j):
                    tau[i][j] = np.vdot(rs[i], rs[j]) / sigma[i]
                    rs[j] = rs[j] - tau[i][j] * rs[i]
                sigma[j] = np.vdot(rs[j], rs[j])
                if abs(sigma[j]) <= brk:
                    dead = True
                    break
                gamma_p[j] = np.vdot(rs[j], rs[0]) / sigma[j]
        if dead:
            # shadow restart from the boundary iterate
            rcount += 1
            if rcount >= 2:
                return x0 + Minv * z_c, None
            z, r = z_c, rs[0]
            rt = rs[0].copy()
            u = np.zeros(n, dense.dtype)
            rho0, alpha, omega = 1.0, 0.0, 1.0
            continue
        rcount = 0
        gam = [None] * (l + 1)
        gam[l] = gamma_p[l]
        omega = gam[l]
        for j in range(l - 1, 0, -1):
            gam[j] = gamma_p[j] - sum(
                tau[j][i] * gam[i] for i in range(j + 1, l + 1)
            )
        gam_pp = [None] * l
        for j in range(1, l):
            gam_pp[j] = gam[j + 1] + sum(
                tau[j][i] * gam[i + 1] for i in range(j + 1, l)
            )
        z_c = z_c + gam[1] * rs[0]
        rs[0] = rs[0] - gamma_p[l] * rs[l]
        us[0] = us[0] - gam[l] * us[l]
        for j in range(1, l):
            us[0] = us[0] - gam[j] * us[j]
            z_c = z_c + gam_pp[j] * rs[j]
            rs[0] = rs[0] - gamma_p[j] * rs[j]
        z, r, u = z_c, rs[0], us[0]
    return x0 + Minv * z, None


def test_bicgstabl_dirichlet_laplacian():
    A, b = _dirichlet()
    x, info = bicgstabl(A.to_dia(), jnp.asarray(b), tol=1e-13, max_iter=500)
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x, jnp.float64))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-12


def test_bicgstabl_matches_dense_oracle_cycles():
    """Same algorithm in numpy: cycle counts within the standard 10% band
    (reduction order is the only difference)."""
    A, b = _dirichlet((16, 16))
    dense = np.asarray(A.todense())
    _, cyc = _dense_bicgstabl_oracle(dense, b, l=2, tol=1e-12, max_iter=500)
    assert cyc is not None
    x, info = bicgstabl(A, jnp.asarray(b), l=2, tol=1e-12, max_iter=500)
    info.raise_if_error()
    assert abs(int(info.iterations) - cyc) <= max(3, cyc // 10)


def test_bicgstabl_nonsymmetric_beats_or_matches_dense_solve():
    rng = np.random.default_rng(1)
    n = 120
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    dense += np.eye(n) * 6.0  # diagonally dominant, nonsymmetric
    A = sp.csr_from_dense(dense)
    b = rng.standard_normal(n)
    x, info = bicgstabl(A, jnp.asarray(b), l=2, tol=1e-12, max_iter=500)
    info.raise_if_error()
    np.testing.assert_allclose(
        np.asarray(x), np.linalg.solve(dense, b), atol=1e-9
    )


def test_bicgstabl_l4_converges_in_fewer_cycles():
    """Each cycle is 2ℓ SpMVs, so ℓ=4 must need roughly half the cycles of
    ℓ=2 on a problem both handle easily."""
    A, b = _dirichlet()
    _, i2 = bicgstabl(A, jnp.asarray(b), l=2, tol=1e-12, max_iter=500)
    _, i4 = bicgstabl(A, jnp.asarray(b), l=4, tol=1e-12, max_iter=500)
    i2.raise_if_error()
    i4.raise_if_error()
    assert int(i4.iterations) < int(i2.iterations)


def _skewed_laplacian(amp, seed=7, shape=(24, 24)):
    """Laplacian + amp·(sparse random skew): eigenvalues migrate off the
    real axis as amp grows — the convection-dominated problem class that
    motivates ℓ ≥ 2 (plain BiCGStab's 1-D MR step handles complex
    eigenpairs poorly)."""
    A = problems.grid_laplacian_dirichlet(shape)
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    skew = np.triu(rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.01))
    skew = skew - skew.T
    dense = np.asarray(A.todense()) + amp * skew
    b = rng.standard_normal(n)
    return dense, b


def test_bicgstabl_beats_bicgstab_on_complex_spectra_spmv_count():
    """Moderately skewed: both converge, BiCGStab(2) in fewer total SpMVs
    (measured 920 vs 1244 at this seed; assert with slack)."""
    dense, b = _skewed_laplacian(0.3)
    Ann = sp.csr_from_dense(dense)
    x2, info2 = bicgstabl(Ann, jnp.asarray(b), l=2, tol=1e-10, max_iter=3000)
    info2.raise_if_error()
    x1, info1 = sp.bicgstab(Ann, jnp.asarray(b), tol=1e-10, max_iter=6000)
    info1.raise_if_error()
    spmv_l2 = 4 * int(info2.iterations)
    spmv_l1 = 2 * int(info1.iterations)
    assert spmv_l2 <= 1.1 * spmv_l1
    np.testing.assert_allclose(
        np.asarray(x2), np.linalg.solve(dense, b), atol=1e-7
    )


def test_bicgstabl_converges_where_bicgstab_diverges():
    """Strongly skewed (max |Im λ| ≈ 2): plain BiCGStab fails (residual
    2.8e4 after 6000 iterations at this seed — and across a 20-seed sweep
    at amp ≥ 0.5, BiCGStab(2) converged in 39 of 40 cases where plain
    BiCGStab failed); the headline robustness case for the ℓ-dimensional
    MR step."""
    dense, b = _skewed_laplacian(0.5, seed=1)
    Ann = sp.csr_from_dense(dense)
    x2, info2 = bicgstabl(Ann, jnp.asarray(b), l=2, tol=1e-10, max_iter=3000)
    info2.raise_if_error()
    np.testing.assert_allclose(
        np.asarray(x2), np.linalg.solve(dense, b), atol=1e-6
    )
    _, info1 = sp.bicgstab(Ann, jnp.asarray(b), tol=1e-10, max_iter=6000)
    assert int(info1.status) != Status.CONVERGED


def test_bicgstabl_jacobi_preconditioned():
    A, b = _dirichlet()
    M = sp.DiagPrecond.new(np.asarray(A.diagonal()))
    x, info = bicgstabl(A, jnp.asarray(b), M=M, tol=1e-12, max_iter=500)
    info.raise_if_error()
    _, info_plain = bicgstabl(A, jnp.asarray(b), tol=1e-12, max_iter=500)
    assert int(info.iterations) <= int(info_plain.iterations)
    r = np.asarray(A.matvec(jnp.asarray(x, jnp.float64))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-11


def test_bicgstabl_complex_symmetric_system():
    A, rhs, diag = problems.complex_symmetric_grid_with_diag((8, 8))
    x, info = bicgstabl(A, jnp.asarray(rhs), l=2, tol=1e-12, max_iter=500)
    info.raise_if_error()
    want = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(x) - want).max() < 1e-9


def test_bicgstabl_warm_start_zero_rhs_and_trace():
    A, b = _dirichlet()
    dense = np.asarray(A.todense())
    x_exact = jnp.asarray(np.linalg.solve(dense, b))
    x, info = bicgstabl(A, jnp.asarray(b), x_exact, tol=1e-8, max_iter=100)
    assert int(info.status) == Status.CONVERGED and int(info.iterations) == 0
    xz, iz = bicgstabl(A, jnp.zeros(400, jnp.float64), tol=1e-10, max_iter=5)
    assert int(iz.status) == Status.CONVERGED
    assert np.all(np.asarray(xz) == 0)
    x, info, hist = bicgstabl(
        A, jnp.asarray(b), tol=1e-10, max_iter=200, record_residuals=True
    )
    info.raise_if_error()
    h = np.asarray(hist)
    it = int(info.iterations)
    assert np.isclose(h[0], 1.0, rtol=1e-6)
    assert np.isfinite(h[: it + 1]).all()
    assert np.isnan(h[it + 1 :]).all()
    assert h[it] <= 1e-10  # converged entry recorded


def test_bicgstabl_insufficient_iterations_status():
    A, b = _dirichlet()
    x, info = bicgstabl(A, jnp.asarray(b), tol=1e-13, max_iter=2)
    assert int(info.status) == Status.INSUFFICIENT_ITER
    assert np.isfinite(np.asarray(x)).all()
    assert float(info.residual) > 1e-13


def test_bicgstabl_through_solve_api_padded_kernel():
    """solve(method='bicgstabl') routes banded matrices through optimize()'s
    DIA layout; result must match the unoptimized CSR path."""
    A, b = _dirichlet()
    x, info = sp.solve(A, b, method="bicgstabl", M="jacobi", tol=1e-11,
                       max_iter=500)
    info.raise_if_error()
    x_flat, _ = sp.solve(A, b, method="bicgstabl", M="jacobi", tol=1e-11,
                         max_iter=500, optimize_layout=False)
    np.testing.assert_allclose(
        np.asarray(x), np.asarray(x_flat), rtol=1e-8, atol=1e-9
    )


def test_bicgstabl_jitted_under_jit():
    A, b = _dirichlet((10, 10))
    run = jax.jit(
        lambda a, rhs: bicgstabl(a, rhs, l=2, tol=1e-11, max_iter=300)
    )
    x, info = run(A.to_dia(), jnp.asarray(b))
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x, jnp.float64))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_bicgstabl_distributed():
    """BiCGStab(2) over the 8-device mesh through HaloDIA + psum dots."""
    from sprsolve_tpu.parallel import distributed_solve

    A, b = _dirichlet((16, 16))
    mesh = jax.make_mesh((8,), ("rows",), devices=jax.devices()[:8])
    x, info = distributed_solve(
        bicgstabl, A.to_dia(), jnp.asarray(b), tol=1e-11, max_iter=500,
        mesh=mesh,
    )
    info.raise_if_error()
    r = np.asarray(A.matvec(jnp.asarray(x, jnp.float64))) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_bicgstabl_near_exact_preconditioner():
    """Regression (found by the solver×precond compatibility matrix): with
    a near-exact M — AMG on a small system, or the exact Jacobi of a
    diagonal matrix — the solve completes inside the first inner step; the
    next step's scalars land at denormal scale, and a strict |.| > 0
    liveness test passed them, amplifying rounding noise by ~1e15 into
    (z, r) while the recurrence residual kept 'converging' (CONVERGED with
    a true residual of 1e-2).  The (eps*||r0||)^2 floor must freeze the
    cycle at the boundary and return the boundary iterate."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    n = 140
    S = sps.random(n, n, density=0.04, random_state=0)
    S = (S + sps.diags(np.abs(S).sum(axis=1).A1 + 1.0)).tocsr()
    b = np.random.default_rng(42).standard_normal(n)
    x, info = sp.solve(sp.csr_from_scipy(S), b, method="bicgstabl",
                       M="amg", tol=1e-10, max_iter=2000)
    info.raise_if_error()
    tr = np.linalg.norm(S @ np.asarray(x) - b) / np.linalg.norm(b)
    assert tr < 1e-9, tr
    # exact-M limit: diagonal system + its exact Jacobi
    d = np.linspace(1.0, 9.0, 64)
    D = sp.csr_from_scipy(sps.diags(d).tocsr())
    bd = np.random.default_rng(3).standard_normal(64)
    xd, infod = sp.solve(D, bd, method="bicgstabl", M="jacobi",
                         tol=1e-12, max_iter=50)
    infod.raise_if_error()
    np.testing.assert_allclose(np.asarray(xd), bd / d, rtol=1e-10)
