"""Operator-optimization tests: format selection (DIA with narrow bands for
stencils, native c64 DIA for complex stencils, BSR/hybrid/RCM otherwise)."""


import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.utils import problems


def test_optimize_picks_pallas_dia_for_stencil():
    """Banded f32 → the XLA DIA operator, bands stored narrow, flat vectors
    (no internal layout)."""
    A = problems.grid_laplacian_dirichlet((16, 16), dtype=np.float32)
    op = sp.optimize(A)
    assert isinstance(op, sp.DIA) and not hasattr(op, "pad_vec")
    assert op.bands.dtype == jnp.int8 and op.dtype == jnp.float32
    x = jnp.asarray(np.random.default_rng(0).standard_normal(256).astype(np.float32))
    got = np.asarray(op.matvec(x))
    np.testing.assert_allclose(got, np.asarray(A.matvec(x)), rtol=1e-5, atol=1e-5)


def test_optimize_routes_x64_to_xla_dia():
    # f64 bands are kept at full width (narrowing covers f32 only)
    A = problems.grid_laplacian_dirichlet((16, 16))
    op = sp.optimize(A)
    assert isinstance(op, sp.DIA) and op.bands.dtype == jnp.float64


def test_optimize_routes_random_pattern_off_ell():
    """A non-banded pattern must land on a structured layout (Reordered DIA
    or BSR), never the scalar-gather ELL path."""
    import scipy.sparse as sps

    S = sps.random(300, 300, density=0.02, random_state=0, format="csr")
    S = S + sps.eye(300)
    A = sp.csr_from_scipy(S)
    op = sp.optimize(A)
    assert not isinstance(op, sp.ELL)
    x = np.random.default_rng(3).standard_normal(300)
    if hasattr(op, "pad_vec"):
        got = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(jnp.asarray(x)))))
    else:
        got = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, S @ x, rtol=1e-10, atol=1e-12)


def test_optimize_reordered_solve_roundtrip():
    """End-to-end solve() through a Reordered operator: permutations at the
    boundary only, original-order solution returned."""
    import scipy.sparse as sps

    rng = np.random.default_rng(7)
    # banded SPD-ish system hidden behind a random symmetric permutation
    n = 240
    base = sps.diags(
        [rng.standard_normal(n - 3), np.full(n, 8.0), rng.standard_normal(n - 3)],
        [-3, 0, 3],
        format="csr",
    )
    p = rng.permutation(n)
    P = sps.eye(n, format="csr")[p]
    S = (P @ base @ P.T).tocsr()
    A = sp.csr_from_scipy(S)
    op = sp.optimize(A)
    from sprsolve_tpu.ops.reordered import Reordered

    assert isinstance(op, Reordered)
    b = rng.standard_normal(n)
    x, info = sp.solve(A, b, M="jacobi", tol=1e-12, max_iter=500)
    info.raise_if_error()
    assert np.linalg.norm(S @ np.asarray(x) - b) / np.linalg.norm(b) < 1e-10


def test_optimize_ell_fallback_warns():
    """With every structured route disabled, the last-resort ELL path must
    warn loudly (complex matrices now route to ComplexBSR by default, and
    random patterns with this density can qualify for the band+outlier
    hybrid, so both have to be switched off to reach the fallback)."""
    import warnings

    import scipy.sparse as sps

    S = sps.random(300, 300, density=0.05, random_state=1, format="csr")
    S = (S + sps.eye(300)).astype(np.complex128)
    A = sp.csr_from_scipy(S)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        op = sp.optimize(A, allow_reorder=False, wide_diags=0, allow_bsr=False,
                         allow_hybrid=False)
    assert isinstance(op, sp.ELL)
    assert any(issubclass(x.category, RuntimeWarning) for x in w)


def test_complex_padded_dia_matches_oracle():
    A, rhs = problems.hermitian_grid((8, 8), dtype=np.complex64)
    op = sp.optimize(A)
    assert isinstance(op, sp.DIA) and op.dtype == jnp.complex64
    x = jnp.asarray(
        (np.random.default_rng(1).standard_normal(64)
         + 1j * np.random.default_rng(2).standard_normal(64)).astype(np.complex64)
    )
    got = np.asarray(op.matvec(x))
    want = np.asarray(A.matvec(x))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_complex_padded_dia_fused_dotmv():
    """c64 DIA matvec_dot matches matvec + conj_dot composed."""
    from sprsolve_tpu.vecalg import conj_dot

    A, rhs = problems.hermitian_grid((8, 8), dtype=np.complex64)
    op = sp.optimize(A)
    rng = np.random.default_rng(5)
    x = jnp.asarray(
        (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(
            np.complex64
        )
    )
    y, dot = op.matvec_dot(x)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(A.matvec(x)), rtol=2e-5, atol=2e-5
    )
    want_dot = complex(conj_dot(x, op.matvec(x)))
    assert abs(complex(dot) - want_dot) <= 1e-4 * max(1.0, abs(want_dot))


def test_complex_solve_via_pallas_layout():
    """CS-MINRES on the complex-symmetric system on optimize()'s c64 DIA."""
    A, rhs, _ = problems.complex_symmetric_grid_with_diag((8, 8), dtype=np.complex64)
    op = sp.optimize(A)
    x, info = sp.cs_minres(op, jnp.asarray(rhs), tol=1e-5, max_iter=300)
    info.raise_if_error()
    xk = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(np.asarray(x) - xk).max() < 1e-2


def test_complex_vectors_cross_jit_natively():
    """c64 operator, right-hand side and solution cross the jit boundary as
    complex arrays (no real-planes detour)."""
    import jax

    A, rhs, _ = problems.complex_symmetric_grid_with_diag((8, 8), dtype=np.complex64)
    op = sp.optimize(A)
    solve = jax.jit(lambda a, b: sp.cs_minres(a, b, tol=1e-5, max_iter=300))
    x, info = solve(op, jnp.asarray(rhs.astype(np.complex64)))
    info.raise_if_error()
    assert x.dtype == jnp.complex64
    x = np.asarray(x)
    xk = np.array([complex(i, j) for i in range(8) for j in range(8)])
    assert np.abs(x - xk).max() < 1e-2


def test_optimize_cost_model_weighs_efficiency_not_bytes(monkeypatch):
    """A fully-dense band of 129 diagonals: wide XLA-DIA is BYTE-cheaper
    (~4.1 B/nnz vs ~8 for BSR).  With DIA at a fraction of BSR's share of
    the HBM peak the time-weighted model must pick BSR even so (the
    pure-byte model chose the slower path on such a device)."""
    import scipy.sparse as sps

    import importlib

    opt = importlib.import_module("sprsolve_tpu.ops.optimize")

    monkeypatch.setattr(opt, "EFF_XLA_DIA", 0.19)
    monkeypatch.setattr(opt, "EFF_BSR", 0.90)

    n, hw = 4096, 64  # bandwidth 64 → 129 dense diagonals
    rng = np.random.default_rng(0)
    diags = [rng.standard_normal(n - abs(k)).astype(np.float32)
             for k in range(-hw, hw + 1)]
    S = sps.diags(diags, list(range(-hw, hw + 1)), format="csr")
    S = (S + sps.eye(n, format="csr") * 200.0).astype(np.float32)
    A = sp.csr_from_scipy(S)
    op = sp.optimize(A)

    def inner_of(o):
        return o.inner if hasattr(o, "inner") else o

    assert isinstance(inner_of(op), sp.BSR), type(op)
    # correctness through the routed operator
    x = rng.standard_normal(n).astype(np.float32)
    if hasattr(op, "pad_vec"):
        got = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(jnp.asarray(x)))))
    else:
        got = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, S @ x, rtol=2e-4, atol=2e-3)


def test_optimize_measure_picks_and_persists(tmp_path, monkeypatch):
    """measure=True: candidates are timed on the backend, the winner's label
    persists keyed by the pattern signature, and a re-run resolves from the
    cache without measuring (the mkl_sparse_optimize amortization story)."""
    import json

    import scipy.sparse as sps

    from sprsolve_tpu.utils import tuning

    monkeypatch.setenv("SPRSOLVE_TUNE_CACHE", str(tmp_path / "autotune.json"))
    tuning._MEM.update(path=None, mtime=None, data={})
    try:
        n, hw = 1024, 16  # 33 dense diagonals: both DIA and BSR candidates
        rng = np.random.default_rng(1)
        diags = [rng.standard_normal(n - abs(k)).astype(np.float32)
                 for k in range(-hw, hw + 1)]
        S = sps.diags(diags, list(range(-hw, hw + 1)), format="csr")
        S = (S + sps.eye(n, format="csr") * 100.0).astype(np.float32)
        A = sp.csr_from_scipy(S)
        op = sp.optimize(A, measure=True, measure_iters=3)
        # the measured winner is a structured layout and computes correctly
        assert not isinstance(op, sp.ELL)
        x = rng.standard_normal(n).astype(np.float32)
        if hasattr(op, "pad_vec"):
            got = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(jnp.asarray(x)))))
        else:
            got = np.asarray(op.matvec(jnp.asarray(x)))
        np.testing.assert_allclose(got, S @ x, rtol=2e-4, atol=2e-3)
        # persisted entry with the winner's label and a throughput record
        saved = json.load(open(tmp_path / "autotune.json"))
        (key, ent), = saved.items()
        assert key.startswith("layout|") and "float32" in key
        assert ent["label"].startswith(("dia", "bsr")) and ent["gnnz_s"] > 0
        # second call resolves from the cache: same layout class, no new
        # measurement (the stored entry is unchanged, incl. its timestamp)
        op2 = sp.optimize(A, measure=True, measure_iters=3)
        assert type(op2) is type(op)
        saved2 = json.load(open(tmp_path / "autotune.json"))
        assert saved2 == saved
    finally:
        tuning._MEM.update(path=None, mtime=None, data={})


def test_optimize_measure_complex_planes(tmp_path, monkeypatch):
    """measure=True on an unstructured complex matrix: each candidate
    (ComplexBSR included) is timed on native c64 vectors and the returned
    operator matches the scipy oracle."""
    import scipy.sparse as sps

    from sprsolve_tpu.utils import tuning

    monkeypatch.setenv("SPRSOLVE_TUNE_CACHE", str(tmp_path / "autotune.json"))
    tuning._MEM.update(path=None, mtime=None, data={})
    try:
        rng = np.random.default_rng(2)
        S = sps.random(400, 400, density=0.03, random_state=2, format="csr")
        S = (S + sps.eye(400)).astype(np.complex64)
        S.data = S.data + 0.5j * rng.standard_normal(len(S.data)).astype(
            np.float32
        )
        A = sp.csr_from_scipy(S)
        op = sp.optimize(A, measure=True, measure_iters=3)
        assert not isinstance(op, sp.ELL)
        x = (rng.standard_normal(400) + 1j * rng.standard_normal(400)).astype(
            np.complex64
        )
        if hasattr(op, "pad_vec"):
            got = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(jnp.asarray(x)))))
        else:
            got = np.asarray(op.matvec(jnp.asarray(x)))
        np.testing.assert_allclose(got, S @ x, rtol=2e-4, atol=2e-3)
    finally:
        tuning._MEM.update(path=None, mtime=None, data={})


def test_optimize_cost_model_uses_card_shares():
    """With the shares measured on the H100 (DIA and BSR both near two
    thirds of the HBM peak) the byte-cheaper wide DIA wins the same dense
    129-diagonal band."""
    import scipy.sparse as sps

    import importlib

    opt = importlib.import_module("sprsolve_tpu.ops.optimize")

    assert abs(opt.EFF_XLA_DIA - opt.EFF_BSR) < 0.1
    n, hw = 4096, 64
    rng = np.random.default_rng(0)
    diags = [rng.standard_normal(n - abs(k)).astype(np.float32)
             for k in range(-hw, hw + 1)]
    S = sps.diags(diags, list(range(-hw, hw + 1)), format="csr")
    S = (S + sps.eye(n, format="csr") * 200.0).astype(np.float32)
    op = sp.optimize(sp.csr_from_scipy(S))
    inner = op.inner if hasattr(op, "inner") else op
    assert isinstance(inner, sp.DIA) and len(inner.offsets) == 2 * hw + 1
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(jnp.asarray(x))))
                     if hasattr(op, "pad_vec") else op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, S @ x, rtol=2e-4, atol=2e-3)
