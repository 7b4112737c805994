"""Card check: drive sprsolve_tpu's main path once on one NVIDIA GPU.

Runs the normal entry points (``solve()``/``optimize()``) at sizes a user of
a sparse solver would call real — every system is past the H100's 50 MB L2 —
and checks each answer on the host against SciPy in f64/c128:

1. device: the first JAX device must be a GPU (no CPU fallback);
2. 7-point 3-D Poisson at 216³ = 10.08M rows, f32: BiCGStab + Jacobi and
   MINRES;
3. the same grid as a damped complex-symmetric c64 system (centre band
   + 0.5i): COCG + Jacobi and CS-MINRES + real |d| Jacobi;
4. general sparsity: a 65,536-row block-random pattern (4 dense 128×128
   blocks per block row, 33.5M nnz) routed by ``optimize()`` to BSR, solved
   by BiCGStab + Jacobi;
5. parity: one SpMV of every layout the path compiled (narrow-band DIA,
   c64 DIA, BSR) against the SciPy product.

The last stdout line is ``{"ok": true, "device": {...}}``; any failed check
raises before it.  ``--four-cards`` runs only the row-partitioned path
(``distributed_solve`` over a 1-D mesh of 4 GPUs, HaloDIA and AllGatherELL)
and the one-card solve it is compared with.

    python chip_smoke.py [--four-cards]

Tolerances (each with its reason):

- TRUE_RES_TOL = 1e-5: true relative residual ‖b − A·x‖/‖b‖ (f64 on the
  host) of a solve asked for 1e-6 in f32/c64 — the recurrence residual
  drifts from the true one by rounding over ~10M-row reductions and
  hundreds of iterations.
- MINRES_TRUE_RES_TOL = 1e-3 for f32 MINRES: its tolerance test reads the
  Givens recurrence estimate, which in f32 parts from the true residual as
  the Lanczos basis loses orthogonality; the attainable true residual is
  ~u·κ(A) ≈ 6e-8 · 1.9e4 ≈ 1.1e-3 at 216³ (κ of the 7-point Poisson).
- one SpMV: every row must satisfy |y − y_ref| ≤ γ·u·(|A|·|x|) with
  u = 2⁻²⁴ and γ = k (real) or 2k (complex) for k terms per row — the
  standard forward error bound of a length-k floating-point dot product;
  the norm-wise relative error is printed beside it.
- four cards: both solves reach TRUE_RES_TOL, and the solutions differ by at
  most DIST_TOL = 1e-2 relative — the forward difference of two 1e-6
  residual solutions is bounded by 2·κ(A)·1e-6 ≈ 4e-2 (κ ≈ 1.9e4 at 216³),
  while a wrong partition or halo gives O(1).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GRID = 216
TOL = 1e-6
TRUE_RES_TOL = 1e-5
MINRES_TRUE_RES_TOL = 1e-3
DIST_TOL = 1e-2
BLOCK_ROWS = 65536
U32 = 2.0 ** -24


def log(*a):
    print(*a, flush=True)


def poisson_system(seed: int):
    """216³ Poisson CSR (f32) and a seeded right-hand side."""
    from sprsolve_tpu.utils import problems

    A = problems.poisson3d(GRID, GRID, GRID, dtype=np.float32)
    b = np.random.default_rng(seed).standard_normal(A.shape[0]).astype(np.float32)
    return A, b


def scipy_of(A, dtype):
    import scipy.sparse as sps

    return sps.csr_matrix(
        (np.asarray(A.data).astype(dtype), np.asarray(A.indices),
         np.asarray(A.indptr)), shape=A.shape,
    )


def true_residual(S, x, b) -> float:
    x = np.asarray(x).astype(S.dtype)
    b = np.asarray(b).astype(S.dtype)
    return float(np.linalg.norm(b - S @ x) / np.linalg.norm(b))


def run_solve(name, S, A, b, limit=TRUE_RES_TOL, **kw):
    """solve(), then check convergence and the host true residual."""
    import jax

    import sprsolve_tpu as sp

    t0 = time.perf_counter()
    x, info = sp.solve(A, b, tol=TOL, **kw)
    jax.block_until_ready(x)
    wall = time.perf_counter() - t0
    info.raise_if_error()
    res = true_residual(S, x, b)
    log(f"{name}: {int(info.iterations)} iters, recurrence res "
        f"{float(info.residual):.3e}, true res {res:.3e} "
        f"(limit {limit:g}), {wall:.2f} s wall incl. layout+compile")
    if not res <= limit:
        raise AssertionError(f"{name}: true residual {res:.3e} > {limit:g}")
    return x, info


def check_spmv(name, op, S, x_host, terms_per_row, complex_=False):
    """One compiled SpMV of ``op`` against the SciPy f64/c128 product."""
    import jax
    import jax.numpy as jnp

    y = np.asarray(jax.jit(lambda o, v: o.matvec(v))(op, jnp.asarray(x_host)))
    wide = np.complex128 if complex_ else np.float64
    xw = x_host.astype(wide)
    y_ref = S @ xw
    bound = (2 if complex_ else 1) * terms_per_row * U32 * (abs(S) @ np.abs(xw))
    err = np.abs(y.astype(wide) - y_ref)
    worst = float(np.max(err / np.maximum(bound, np.finfo(np.float64).tiny)))
    rel = float(np.linalg.norm(err) / np.linalg.norm(y_ref))
    log(f"parity {name}: norm-wise rel err {rel:.3e}; worst row at "
        f"{worst:.3f} of its bound {2 if complex_ else 1}·{terms_per_row}·u·|A||x|")
    if not worst <= 1.0:
        raise AssertionError(f"parity {name}: a row exceeds its error bound")


def block_random(seed: int, n: int = 65536):
    """Diagonally dominant block-random f32 CSR: 4 dense 128×128 blocks per
    block row (the diagonal block among them) on 65,536 rows."""
    from sprsolve_tpu.sparse.containers import CSR

    bs, bpr = 128, 4
    nb = n // bs
    rng = np.random.default_rng(seed)
    brows = np.repeat(np.arange(nb), bpr)
    bcols = rng.integers(0, nb, nb * bpr)
    bcols[::bpr] = np.arange(nb)  # the diagonal block
    key = np.unique(brows.astype(np.int64) * nb + bcols)
    brows, bcols = key // nb, key % nb
    nblk = len(key)
    rows = (brows[:, None, None] * bs + np.arange(bs)[:, None]).repeat(bs, axis=2)
    cols = (bcols[:, None, None] * bs + np.arange(bs)[None, None, :]).repeat(bs, axis=1)
    vals = rng.standard_normal(nblk * bs * bs).astype(np.float32)
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    on_diag = rows == cols
    absrow = np.bincount(rows, weights=np.abs(vals), minlength=n)
    vals[on_diag] = (absrow[rows[on_diag]] + 1.0).astype(np.float32)
    order = np.lexsort((cols, rows))
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    A = CSR.from_arrays(vals[order], cols[order].astype(np.int32), indptr, (n, n))
    b = rng.standard_normal(n).astype(np.float32)
    return A, b


def one_card() -> None:
    import jax.numpy as jnp

    import sprsolve_tpu as sp
    from sprsolve_tpu.sparse.bsr import BSR
    from sprsolve_tpu.sparse.containers import CSR, DIA

    # --- real banded system (the headline path) ---
    t0 = time.perf_counter()
    A, b = poisson_system(seed=0)
    S64 = scipy_of(A, np.float64)
    log(f"poisson 216^3: n={A.shape[0]} nnz={A.nnz} (bands {7 * A.shape[0] * 4 / 1e6:.0f} MB "
        f"in f32), host build {time.perf_counter() - t0:.1f} s")
    op = sp.optimize(A)
    if not isinstance(op, DIA):
        raise AssertionError(f"optimize() routed the stencil to {type(op).__name__}")
    log(f"optimize(): DIA, bands stored as {op.bands.dtype}, computed in {op.dtype}")
    run_solve("bicgstab+jacobi f32", S64, A, b, method="bicgstab", M="jacobi",
              max_iter=5000)
    run_solve("minres f32", S64, A, b, method="minres", max_iter=10000,
              limit=MINRES_TRUE_RES_TOL)
    rng = np.random.default_rng(1)
    x_h = rng.standard_normal(A.shape[0]).astype(np.float32)
    check_spmv("DIA f32 (narrow bands)", op, S64, x_h, terms_per_row=7)

    # --- complex banded system ---
    data = np.asarray(A.data).astype(np.complex64)
    data[np.asarray(A.indices) == np.asarray(A.row_ids)] += np.complex64(0.5j)
    Ac = CSR.from_arrays(data, A.indices, A.indptr, A.shape)
    bc = (b + 0.25j * np.random.default_rng(2).standard_normal(A.shape[0])).astype(np.complex64)
    Sc = scipy_of(Ac, np.complex128)
    opc = sp.optimize(Ac)
    if not (isinstance(opc, DIA) and opc.dtype == jnp.complex64):
        raise AssertionError(f"optimize() routed the c64 stencil to {opc!r:.80}")
    run_solve("cocg+jacobi c64", Sc, Ac, bc, method="cocg", M="jacobi",
              max_iter=5000)
    run_solve("cs_minres+|d| jacobi c64", Sc, Ac, bc, method="cs_minres",
              M="jacobi", max_iter=5000)
    xc = (x_h + 1j * rng.standard_normal(A.shape[0])).astype(np.complex64)
    check_spmv("DIA c64", opc, Sc, xc, terms_per_row=7, complex_=True)
    del Sc, S64, op, opc

    # --- general sparsity ---
    t0 = time.perf_counter()
    Ag, bg = block_random(seed=3, n=BLOCK_ROWS)
    Sg = scipy_of(Ag, np.float64)
    log(f"block-random: n={Ag.shape[0]} nnz={Ag.nnz} "
        f"({Ag.nnz * 4 / 1e6:.0f} MB of f32 values), host build "
        f"{time.perf_counter() - t0:.1f} s")
    opg = sp.optimize(Ag)
    inner = getattr(opg, "inner", opg)
    if not isinstance(inner, BSR):
        raise AssertionError(f"optimize() routed block-random to {type(inner).__name__}")
    log(f"optimize(): {type(opg).__name__} over BSR bs={inner.bs}, "
        f"{inner.nblk} blocks")
    run_solve("bicgstab+jacobi f32 BSR", Sg, Ag, bg, method="bicgstab",
              M="jacobi", max_iter=500)
    xg = rng.standard_normal(Ag.shape[0]).astype(np.float32)
    if opg is inner:
        check_spmv(f"BSR{inner.bs} f32", inner, Sg, xg,
                   terms_per_row=int(np.diff(np.asarray(Ag.indptr)).max()))
    else:
        # solve space is permuted: compare the inner operator on permuted x
        perm = np.asarray(opg.perm)
        Sp = Sg[perm][:, perm]
        check_spmv(f"BSR{inner.bs} f32 (RCM order)", inner, Sp, xg,
                   terms_per_row=int(np.diff(np.asarray(Ag.indptr)).max()))


def four_cards() -> None:
    import jax
    import jax.numpy as jnp

    import sprsolve_tpu as sp
    from sprsolve_tpu.parallel import distributed_solve

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX found {len(devs)}")
    mesh = jax.make_mesh((4,), ("rows",), devices=devs[:4])
    A, b = poisson_system(seed=0)
    S64 = scipy_of(A, np.float64)
    M = sp.DiagPrecond.new(np.asarray(A.diagonal()))
    x1, info1 = run_solve("one card: bicgstab+jacobi f32", S64, A, b,
                          method="bicgstab", M="jacobi", max_iter=5000)
    x1 = np.asarray(x1, np.float64)
    for name, A_in in (("HaloDIA", A.to_dia()), ("AllGatherELL", A)):
        t0 = time.perf_counter()
        x4, info4 = distributed_solve(
            sp.bicgstab, A_in, jnp.asarray(b), M=M, tol=TOL, max_iter=5000,
            mesh=mesh,
        )
        jax.block_until_ready(x4)
        wall = time.perf_counter() - t0
        info4.raise_if_error()
        shard_devs = {s.device for s in x4.addressable_shards}
        res = true_residual(S64, x4, b)
        diff = float(np.linalg.norm(np.asarray(x4, np.float64) - x1)
                     / np.linalg.norm(x1))
        log(f"4 cards {name}: {int(info4.iterations)} iters (one card "
            f"{int(info1.iterations)}), true res {res:.3e}, |x4-x1|/|x1| "
            f"{diff:.3e} (limit {DIST_TOL:g}), shards on "
            f"{sorted(str(d) for d in shard_devs)}, {wall:.2f} s wall")
        if len(shard_devs) != 4:
            raise AssertionError(f"{name}: result on {len(shard_devs)} devices")
        if not (res <= TRUE_RES_TOL and diff <= DIST_TOL):
            raise AssertionError(f"{name}: disagrees with the one-card solve")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU distributed path and its "
                         "one-card comparison")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2

    from sprsolve_tpu.utils.timing import device_peaks, enable_compile_cache

    cache = enable_compile_cache(HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    peaks = device_peaks(devs[0].device_kind)
    log(f"device: {devs[0].device_kind} x{len(devs)} ({peaks['source']}); "
        f"compile cache {cache}")
    log(f"nvidia-smi: {smi}")

    four_cards() if args.four_cards else one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
