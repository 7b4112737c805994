"""The banded DIA path (XLA shifted slices) that ``optimize()`` returns for
stencil matrices, validated against the CSR gather oracle; and the package
import surface (no Pallas modules).  Timing on the card lives in
``chip_smoke.py``/``bench.py``."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.ops.reordered import Reordered
from sprsolve_tpu.ops.spmv import spmv_csr, spmv_dia
from sprsolve_tpu.sparse.containers import CSR, DIA
from sprsolve_tpu.utils import problems


def test_poisson3d_matches_oracle():
    """Narrow-band f32 DIA (optimize()'s route) against the CSR oracle."""
    A = problems.poisson3d(10, 10, 10, dtype=np.float32)
    op = sp.optimize(A)
    assert isinstance(op, DIA) and op.bands.dtype == jnp.int8
    x = jnp.asarray(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    want = np.asarray(spmv_csr(A, x))
    got = np.asarray(op.matvec(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid2d_matches_oracle_f64():
    A = problems.grid_laplacian_dirichlet((20, 20))
    dia = A.to_dia()
    x = jnp.asarray(np.random.default_rng(1).standard_normal(400))
    want = np.asarray(spmv_csr(A, x))
    got = np.asarray(spmv_dia(dia, x))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_padded_layout_roundtrip():
    A = problems.poisson3d(8, 8, 8, dtype=np.float32)
    perm = np.random.default_rng(2).permutation(512)
    op = Reordered.wrap(A.to_dia(), perm)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(512).astype(np.float32))
    x2 = op.pad_vec(x)
    np.testing.assert_array_equal(np.asarray(x2), np.asarray(x)[perm])
    np.testing.assert_array_equal(np.asarray(op.unpad_vec(x2)), np.asarray(x))


def test_solver_runs_in_padded_layout():
    """A whole Krylov solve runs in the permuted layout of an RCM-reordered
    operator; only the boundary converts."""
    A = problems.poisson3d(8, 8, 8, dtype=np.float64)
    from sprsolve_tpu.sparse.containers import reorder_rcm

    Ap, perm = reorder_rcm(A)
    op = Reordered.wrap(DIA.from_csr(Ap, max_diags=512), perm)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(512))
    x2, info = sp.bicgstab(op, op.pad_vec(b), tol=1e-12, max_iter=500)
    info.raise_if_error()
    x = op.unpad_vec(x2)
    r = np.asarray(A.matvec(x)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-10


def test_fused_matvec_dot_matches_unfused():
    A = problems.poisson3d(10, 10, 10, dtype=np.float64)
    dia = A.to_dia()
    x = jnp.asarray(np.random.default_rng(4).standard_normal(1000))
    y_fused, d_fused = dia.matvec_dot(x)
    y_ref = dia.matvec(x)
    np.testing.assert_allclose(np.asarray(y_fused), np.asarray(y_ref), rtol=1e-14)
    want = np.vdot(np.asarray(x), np.asarray(y_ref))
    np.testing.assert_allclose(float(d_fused), want, rtol=1e-12)


def test_minres_uses_fused_dotmv_in_pallas_layout():
    A, rhs = problems.sym_grid_laplacian((16, 16))
    A32 = CSR.from_arrays(np.asarray(A.data, np.float32), A.indices, A.indptr,
                          A.shape)
    op = sp.optimize(A32)
    assert op.bands.dtype == jnp.int8 and op.dtype == jnp.float32
    x, info = sp.minres(op, jnp.asarray(rhs, jnp.float32), tol=1e-5,
                        max_iter=600)
    info.raise_if_error()
    r = np.asarray(A.matvec(np.asarray(x, np.float64))) - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-4


def test_import_loads_no_pallas():
    """Importing the package (and running a banded solve) loads no Pallas
    module — no path can run a kernel interpreted."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "import sys, numpy as np, sprsolve_tpu as sp;"
        "from sprsolve_tpu.utils import problems;"
        "A = problems.poisson3d(6, 6, 6, dtype=np.float32);"
        "sp.solve(A, np.ones(216, np.float32), M='jacobi', tol=1e-5);"
        "print(sorted(m for m in sys.modules if 'pallas' in m))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_complex_conj_dotmv_matches_composed():
    """mv_conj_dot == (A·conj(x), conj_dot(x, A·conj(x))) on c64 DIA."""
    from sprsolve_tpu.ops.operator import mv_conj_dot

    A0 = problems.poisson3d(8, 8, 8)
    rng = np.random.default_rng(0)
    data = (np.asarray(A0.data) * (1 - 0.6j)).astype(np.complex64)
    op = sp.optimize(CSR.from_arrays(data, A0.indices, A0.indptr, A0.shape))
    assert isinstance(op, DIA) and op.dtype == jnp.complex64
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
    x = jnp.asarray(x)
    y_f, d_f = mv_conj_dot(op, x)
    y_c = op.matvec(jnp.conj(x))
    d_c = jnp.sum(jnp.conj(x) * y_c)
    np.testing.assert_allclose(np.asarray(y_f), np.asarray(y_c), rtol=2e-5,
                               atol=2e-5)
    assert abs(complex(d_f) - complex(d_c)) < 1e-2 * max(1.0, abs(complex(d_c)))


def test_wide_band_dia_matches_oracle():
    """16 unnarrowable f32 bands at long offsets (the wide-band case)."""
    n = 1 << 13
    rng = np.random.default_rng(0)
    offs = tuple(sorted({0, 1, -1, 5, -5, 17, -17, 130, -130, 700, -700,
                         23, -23, 64, -64, 9}))
    bands = rng.standard_normal((len(offs), n)).astype(np.float32)
    for d, o in enumerate(offs):
        if o > 0:
            bands[d, n - o:] = 0
        elif o < 0:
            bands[d, :(-o)] = 0
    dia = DIA(bands=jnp.asarray(bands), offsets=offs, shape=(n, n))
    assert dia.narrow() is dia  # random values: no exact narrow dtype
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(spmv_dia(dia, jnp.asarray(x)))
    want = np.zeros(n)
    for d, o in enumerate(offs):
        lo, hi = max(0, -o), min(n, n - o)
        want[lo:hi] += bands[d, lo:hi].astype(np.float64) * x[lo + o:hi + o]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
