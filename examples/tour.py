"""Tour of the framework surface: every solver family and preconditioner on
small problems, with true-residual checks.  A user of the reference crate
switching over can skim this file to find each capability.

Run: python examples/tour.py   (CPU is fine)
"""

import io
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu import scipy_compat
from sprsolve_tpu.utils import mmread, mmwrite, problems


def relres(A, x, b):
    r = np.asarray(A.matvec(jnp.asarray(x, jnp.result_type(b)))) - b
    return np.linalg.norm(r) / np.linalg.norm(b)


# --- the reference's own flagship workload -------------------------------
A = problems.grid_laplacian_dirichlet((20, 20))
b = np.zeros(400)
problems.set_boundary_condition(b, (20, 20), lambda r, c: float(r + c))

x, (iters, res) = sp.BiCGStab.new(A, 400).solve(b, max_iter=1500, tol=1e-15)
print(f"BiCGStab (object API):      {iters:4d} iters  rel-res {relres(A, x, b):.2e}")

x, info = sp.solve(A, b, M="jacobi", tol=1e-15, max_iter=1500)
print(f"BiCGStab + Jacobi:          {int(info.iterations):4d} iters  rel-res {relres(A, x, b):.2e}")

# --- SPD path: CG / MINRES with the stronger preconditioners --------------
Aspd = sp.csr_from_dense(-np.asarray(problems.sym_grid_laplacian((24, 24))[0].todense()))
bspd = np.random.default_rng(0).standard_normal(576)

for name, M in [
    ("CG  + block-Jacobi", sp.BlockJacobiPrecond.from_csr(Aspd, block_size=16)),
    ("CG  + IC(0)", sp.IC0Precond.from_csr(Aspd)),
    ("CG  + Chebyshev(auto)", sp.ChebyshevPrecond.auto(Aspd.to_dia(), degree=6)),
    ("CG  + multigrid", sp.GridMGPrecond.from_csr(Aspd, (24, 24), coarse_max=36)),
]:
    x, info = sp.solve(Aspd, bspd, method="cg", M=M, tol=1e-10, max_iter=2000)
    print(f"{name:27s} {int(info.iterations):4d} iters  rel-res {relres(Aspd, x, bspd):.2e}")

colors = sp.greedy_color(Aspd)
ssor = sp.MaskedGSPrecond(
    A=Aspd.to_dia(), diag=Aspd.diagonal(), masks=sp.color_masks(colors),
    omega=1.5, symmetric=True,
)
x, info = sp.solve(Aspd, bspd, method="minres", M=ssor, tol=1e-10, max_iter=2000)
print(f"{'MINRES + SSOR':27s} {int(info.iterations):4d} iters  rel-res {relres(Aspd, x, bspd):.2e}")

# --- general nonsymmetric: GMRES ------------------------------------------
x, info = sp.solve(A, b, method="gmres", restart=32, tol=1e-12, max_iter=1000)
print(f"{'GMRES(32)':27s} {int(info.iterations):4d} iters  rel-res {relres(A, x, b):.2e}")

# --- inner-outer: FGMRES with a budgeted inner CG as the preconditioner ----
Minner = sp.InnerSolvePrecond(
    Aspd, inner_M=sp.DiagPrecond.new(Aspd.diagonal()), method="cg", iters=8
)
x, info = sp.solve(
    Aspd, bspd, method="fgmres", M=Minner, restart=30, tol=1e-10, max_iter=600
)
print(f"{'FGMRES(30) + inner CG(8)':27s} {int(info.iterations):4d} iters  rel-res {relres(Aspd, x, bspd):.2e}")

# --- hard nonsymmetric: IDR(s) ---------------------------------------------
x, info = sp.solve(A, b, method="idrs", s=4, tol=1e-12, max_iter=3000)
print(f"{'IDR(4)':27s} {int(info.iterations):4d} SpMVs  rel-res {relres(A, x, b):.2e}")

# --- complex spectra: BiCGStab(2) — converges where plain BiCGStab fails
# (the 24x24 seed-1 strongly-skewed system of tests/test_bicgstabl.py:
# plain BiCGStab ends 6000 iterations at rel-res ~2.8e4 on it)
_AL = problems.grid_laplacian_dirichlet((24, 24))
_rngL = np.random.default_rng(1)
_nL = _AL.shape[0]
_skew = np.triu(_rngL.standard_normal((_nL, _nL)) * (_rngL.random((_nL, _nL)) < 0.01))
_skew = _skew - _skew.T
Ask = sp.csr_from_dense(np.asarray(_AL.todense()) + 0.5 * _skew)
bsk = _rngL.standard_normal(_nL)
x, info = sp.solve(Ask, bsk, method="bicgstabl", l=2, tol=1e-10,
                   max_iter=3000, optimize_layout=False)
print(f"{'BiCGStab(2), skewed':27s} {int(info.iterations):4d} cycles "
      f"rel-res {relres(Ask, x, bsk):.2e}  (plain BiCGStab fails here)")

# --- complex symmetric: CS-MINRES (the solver the reference never tests) --
Ac, bc, _diag = problems.complex_symmetric_grid_with_diag((12, 12))
xc, info = sp.cs_minres(Ac, jnp.asarray(bc), tol=1e-12, max_iter=600)
rc = np.asarray(Ac.matvec(jnp.asarray(xc))) - bc
print(f"{'CS-MINRES (c128)':27s} {int(info.iterations):4d} iters  "
      f"rel-res {np.linalg.norm(rc) / np.linalg.norm(bc):.2e}")

# COCG: the cheap complex-symmetric iteration (one SpMV/iter, takes the
# complex Jacobi — beyond the reference's surface)
xg, info = sp.solve(Ac, bc, method="cocg", M="jacobi", tol=1e-12,
                    max_iter=600)
rg = np.asarray(Ac.matvec(jnp.asarray(xg))) - bc
print(f"{'COCG + complex Jacobi':27s} {int(info.iterations):4d} iters  "
      f"rel-res {np.linalg.norm(rg) / np.linalg.norm(bc):.2e}")

# preconditioned CS-MINRES (beyond the reference): real 1/|d| Jacobi, built
# by solve() from the matrix diagonal
xcp, info = sp.solve(Ac, bc, method="cs_minres", M="jacobi", tol=1e-12,
                     max_iter=600)
rcp = np.asarray(Ac.matvec(jnp.asarray(xcp))) - bc
print(f"{'CS-MINRES + |d| Jacobi':27s} {int(info.iterations):4d} iters  "
      f"rel-res {np.linalg.norm(rcp) / np.linalg.norm(bc):.2e}")

# --- unstructured complex: ComplexBSR via plain solve() --------------------
import scipy.sparse as _sps

_rng = np.random.default_rng(42)
_S = _sps.random(400, 400, density=0.02, random_state=42, format="csr")
_S = _S + _sps.eye(400) * 8
_Sc = _sps.csr_matrix(
    (_S.data * (1 + 0.6j * _rng.standard_normal(_S.nnz)), _S.indices,
     _S.indptr), shape=_S.shape,
)
Au = sp.csr_from_scipy(_Sc)
bu = _Sc @ (_rng.standard_normal(400) + 1j * _rng.standard_normal(400))
xu, info = sp.solve(Au, bu, method="bicgstab", M="jacobi", tol=1e-10,
                    max_iter=800)
ru = _Sc @ np.asarray(xu) - bu
print(f"{'unstructured c128 (BSR)':27s} {int(info.iterations):4d} iters  "
      f"rel-res {np.linalg.norm(ru) / np.linalg.norm(bu):.2e}")

# --- least squares: LSQR ---------------------------------------------------
rng = np.random.default_rng(1)
dense = rng.standard_normal((120, 40)) * (rng.random((120, 40)) < 0.2)
dense[np.arange(40), np.arange(40)] += 3.0
Als = sp.csr_from_dense(dense)
bls = rng.standard_normal(120)
xls, info = sp.solve(Als, bls, method="lsqr", tol=1e-12, max_iter=400)
nrm = np.linalg.norm(dense.T @ (bls - dense @ np.asarray(xls)))
print(f"{'LSQR (120x40)':27s} {int(info.iterations):4d} iters  ||A^T r|| {nrm:.2e}")

# --- eigenpairs: LOBPCG ----------------------------------------------------
X0 = jnp.asarray(rng.standard_normal((576, 3)))
lam, V, info = sp.lobpcg(
    Aspd, X0, M=sp.GridMGPrecond.from_csr(Aspd, (24, 24), coarse_max=36),
    tol=1e-8, max_iter=200,
)
print(f"{'LOBPCG smallest 3':27s} {int(info.iterations):4d} iters  "
      f"lambda = {np.array2string(np.asarray(lam), precision=4)}")

# interior eigenpairs near a target: shift-invert (LOBPCG over
# (A - sigma I)^-1, MINRES inner solves inside the jitted iteration)
_lam_si, _Xsi, info = sp.shift_invert_eigs(Aspd, 3, 2.0, tol=1e-7,
                                           max_iter=200)
print(f"{'shift-invert eigs @ 2.0':27s} {int(info.iterations):4d} iters  "
      f"lambda = {np.array2string(np.sort(np.asarray(_lam_si)), precision=4)}")

# --- f64 accuracy at f32 kernel speed: iterative refinement ----------------
Af64 = sp.CSR.from_arrays(np.asarray(Aspd.data, np.float64), Aspd.indices,
                          Aspd.indptr, Aspd.shape)
xr_, info = sp.refine_solve(Af64, bspd, inner="cg", tol=1e-13)
rr = np.linalg.norm(np.asarray(Af64.matvec(jnp.asarray(xr_))) - bspd)
print(f"{'refine_solve (f64 via f32)':27s} {int(info.iterations):4d} outer  "
      f"rel-res {rr / np.linalg.norm(bspd):.2e}")

# --- algebraic multigrid on an unstructured matrix --------------------------
rng_u = np.random.default_rng(7)
W = np.zeros((700, 700))
pts_u = rng_u.random((700, 2))
d2u = ((pts_u[:, None] - pts_u[None])**2).sum(-1); np.fill_diagonal(d2u, np.inf)
nbu = np.argsort(d2u, 1)[:, :5]
W[np.repeat(np.arange(700), 5), nbu.ravel()] = 1; W = np.maximum(W, W.T)
Lg = sp.csr_from_dense(np.diag(W.sum(1)) - W + 0.05 * np.eye(700))
bg = rng_u.standard_normal(700)
xg, info = sp.solve(Lg, bg, method="cg", M="amg", tol=1e-10, max_iter=2000)
print(f"{'CG + amg (unstructured)':27s} {int(info.iterations):4d} iters  "
      f"rel-res {relres(Lg, xg, bg):.2e}")

# --- file IO: Matrix Market round trip ------------------------------------
buf = io.StringIO()
mmwrite(buf, A, comment="Dirichlet Laplacian from the tour")
buf.seek(0)
A_rt = mmread(buf)
x, info = sp.solve(A_rt, b, tol=1e-12, max_iter=1500)
print(f"{'mmread/mmwrite round trip':27s} {int(info.iterations):4d} iters  rel-res {relres(A, x, b):.2e}")

# --- scipy drop-in ---------------------------------------------------------
x, code = scipy_compat.bicgstab(A, b, rtol=1e-12)
print(f"{'scipy_compat.bicgstab':27s} code {code}  rel-res {relres(A, x, b):.2e}")

# --- amortized re-solves ---------------------------------------------------
handle = sp.prepare(A, M="jacobi", tol=1e-12, max_iter=1500)
x1, _ = handle(b)
x2, info2 = handle(np.roll(b, 7), x0=x1)  # warm start from the last solution
print(f"{'prepare() re-solve':27s} {int(info2.iterations):4d} iters (warm-started)")

print("tour complete.")
