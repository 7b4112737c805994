"""Command-line entry: solve a Matrix Market system from the shell.

The runnable counterpart of the reference's demo binary (``src/main.rs``),
grown into a tool: read A (.mtx) and b (.npy/.mtx/text), pick a solver and
preconditioner, print the solve report, optionally write x.

    python -m sprsolve_tpu solve A.mtx --rhs b.npy --method cg --precond amg \
        --tol 1e-10 --max-iter 2000 --out x.npy
    python -m sprsolve_tpu info A.mtx
    python -m sprsolve_tpu eig A.mtx -k 4 --which SA
    python -m sprsolve_tpu eig A.mtx -k 2 --sigma 3.5   # interior, near σ
    python -m sprsolve_tpu eig P.mtx -k 4 --precond mg --grid 100,100,100
"""

from __future__ import annotations

import argparse
import sys
import time


def _load_rhs(path, n, dtype):
    import numpy as np

    if path is None:
        return np.ones(n, dtype=dtype)
    if path.endswith(".npy"):
        b = np.load(path)
    elif path.endswith(".mtx"):
        from .utils.io import mmread

        m = mmread(path)
        b = m if not hasattr(m, "todense") else np.asarray(m.todense())
        b = np.asarray(b).reshape(-1)
    else:
        b = np.loadtxt(path)
    return np.asarray(b, dtype=dtype).reshape(-1)


def _cmd_info(args):
    import numpy as np

    from .utils.io import mmread

    A = mmread(args.matrix)
    if not hasattr(A, "nnz"):
        print(f"{args.matrix}: dense array {A.shape} {A.dtype}")
        return 0
    m, n = A.shape
    print(f"{args.matrix}: {m} x {n}, nnz {A.nnz} "
          f"({A.nnz / max(m, 1):.2f}/row), dtype {np.asarray(A.data).dtype}")
    if m == n:
        from .native import csr_bandwidth, csr_count_diagonals

        indptr = np.asarray(A.indptr, np.int64)
        indices = np.asarray(A.indices, np.int32)
        try:
            bw = csr_bandwidth(m, indptr, indices)
            nd = csr_count_diagonals(m, indptr, indices)
            print(f"bandwidth {bw}, distinct diagonals {nd}")
        except Exception:
            pass
        dense = np.asarray(A.todense()) if m <= 2000 else None
        if dense is not None:
            sym = np.allclose(dense, dense.T)
            herm = np.allclose(dense, dense.conj().T)
            print(f"symmetric: {sym}  hermitian: {herm}")
    return 0


def _cmd_solve(args):
    import numpy as np

    from . import errors, solve
    from .sparse.containers import CSR
    from .utils.io import mmread

    A = mmread(args.matrix)
    if not hasattr(A, "matvec"):
        print("error: matrix file is a dense array; expected sparse", file=sys.stderr)
        return 2
    if args.f32:
        dt = np.complex64 if np.iscomplexobj(np.asarray(A.data)) else np.float32
        A = CSR.from_arrays(
            np.asarray(A.data, dt), A.indices, A.indptr, A.shape
        )
    b = _load_rhs(args.rhs, A.shape[0], np.asarray(A.data).dtype)
    if b.shape[0] != A.shape[0]:
        print(f"error: rhs has {b.shape[0]} entries, matrix has {A.shape[0]} rows",
              file=sys.stderr)
        return 2

    M = args.precond if args.precond != "none" else None
    if args.method == "auto":
        # resolve here so the report line names the method actually run;
        # --refine's inner-solver set has no bicgstabl, so auto under
        # --refine resolves to the reference-parity nonsymmetric path
        from .api import _auto_method

        args.method = _auto_method(
            A, parity="reference" if args.refine else "fast"
        )
    t0 = time.perf_counter()
    try:
        if args.refine:
            from .solvers import refine_solve

            if M not in (None, "jacobi"):
                print("error: --refine supports --precond none|jacobi",
                      file=sys.stderr)
                return 2
            x, info = refine_solve(
                A, b, inner=args.method, M=M, tol=args.tol,
                max_refine=args.max_iter,
            )
        else:
            x, info = solve(
                A, b, method=args.method, M=M, tol=args.tol,
                max_iter=args.max_iter,
            )
    except errors.SolverError as e:
        print(f"solver error: {e}", file=sys.stderr)
        return 1
    import jax

    jax.block_until_ready(x)  # async dispatch: materialize before timing
    wall = time.perf_counter() - t0
    x_np = np.asarray(x)
    r = np.asarray(A.matvec(x)) - b
    relres = float(np.linalg.norm(r) / max(np.linalg.norm(b), 1e-300))
    status = errors.Status(int(info.status)).name
    print(
        f"{args.method}"
        + (f" + {args.precond}" if M is not None else "")
        + f": {int(info.iterations)} iterations, status {status}, "
        f"true rel-res {relres:.3e}, {wall:.3f} s (incl. compile)"
        + (" [refined]" if args.refine else "")
    )
    if args.out:
        np.save(args.out, x_np)
        print(f"wrote {args.out}")
    return 0 if status == "CONVERGED" else 1


def _cmd_eig(args):
    import numpy as np

    from .scipy_compat import eigsh
    from .utils.io import mmread

    A = mmread(args.matrix)
    if not hasattr(A, "matvec"):
        print("error: matrix file is a dense array; expected sparse", file=sys.stderr)
        return 2
    if A.shape[0] != A.shape[1]:
        print("error: eigensolver needs a square matrix", file=sys.stderr)
        return 2
    # --which defaults by mode: --sigma implies shift-invert (LM-nearest-
    # sigma); without a shift, LOBPCG serves the spectrum's ends (SA)
    which = args.which
    if which is None:
        which = "LM" if args.sigma is not None else "SA"
    if args.sigma is not None and which != "LM":
        print("error: --sigma (shift-invert) implies --which LM", file=sys.stderr)
        return 2
    if args.sigma is None and which == "LM":
        # scipy's eigsh default is LM, but without a shift an indefinite
        # spectrum has no LOBPCG analog — steer to the supported ends
        print("error: --which LM needs --sigma; use LA/SA for the spectrum's "
              "ends", file=sys.stderr)
        return 2
    precond = None
    if args.precond != "none":
        if args.sigma is not None:
            print("error: --precond applies to the LOBPCG path (no --sigma)",
                  file=sys.stderr)
            return 2
        if args.precond == "mg":
            # structured-grid multigrid: the difference between converging
            # and not at scale (smallest grid eigenvalues cluster at O(h^2))
            if not args.grid:
                print("error: --precond mg needs --grid NX[,NY[,NZ]]",
                      file=sys.stderr)
                return 2
            grid = tuple(int(g) for g in args.grid.split(","))
            if int(np.prod(grid)) != A.shape[0]:
                print(f"error: --grid {args.grid} has {int(np.prod(grid))} "
                      f"points, matrix has {A.shape[0]} rows",
                      file=sys.stderr)
                return 2
            from .multigrid import GridMGPrecond

            precond = GridMGPrecond.from_csr(A, grid)
        else:
            precond = args.precond  # "jacobi": built inside eigsh
    if args.interior == "rational" and args.sigma is None:
        print("error: --interior rational needs --sigma", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        if args.sigma is not None and args.interior == "rational":
            # FEAST-style contour filter: complex-shifted COCG inner
            # solves, conditioning independent of eigenvalue crowding at
            # sigma — the production deep-interior path (solvers/rational.py)
            from .solvers import rational_filter_eigs

            lam, X, _info = rational_filter_eigs(
                A, args.k, args.sigma, tol=args.tol,
            )
            w, v = np.asarray(lam), np.asarray(X)
        else:
            w, v = eigsh(A, k=args.k, sigma=args.sigma, which=which,
                         tol=args.tol, maxiter=args.max_iter, precond=precond)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    Av = np.asarray(A.matmat(v) if hasattr(A, "matmat") else
                    np.stack([np.asarray(A.matvec(v[:, i])) for i in range(v.shape[1])], axis=1))
    rel = np.linalg.norm(Av - v * w[None, :], axis=0) / np.maximum(np.abs(w), 1e-300)
    kind = (f"nearest sigma={args.sigma:g}" if args.sigma is not None
            else {"LA": "largest", "SA": "smallest"}[which])
    print(f"{args.k} eigenpairs ({kind}), {wall:.3f} s (incl. compile)")
    for i in range(len(w)):
        print(f"  lambda[{i}] = {w[i]:+.10e}   rel-res {rel[i]:.2e}")
    if args.out:
        np.savez(args.out, w=w, v=v)
        print(f"wrote {args.out}")
    return 0 if float(rel.max()) <= max(args.tol * 50, 1e-6) else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sprsolve_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_info = sub.add_parser("info", help="print matrix statistics")
    p_info.add_argument("matrix", help="Matrix Market file")
    p_info.set_defaults(fn=_cmd_info)

    p_solve = sub.add_parser("solve", help="solve A x = b")
    p_solve.add_argument("matrix", help="Matrix Market file for A")
    p_solve.add_argument("--rhs", help=".npy/.mtx/text file for b (default: ones)")
    p_solve.add_argument(
        "--method", default="auto",
        choices=["auto", "bicgstab", "bicgstabl", "ca_bicgstab", "ca_cg",
                 "cg", "cg_single_sync", "cgs", "tfqmr", "minres",
                 "cs_minres", "cocg", "gmres", "fgmres", "idrs", "lsqr"],
    )
    p_solve.add_argument(
        "--precond", default="none",
        choices=["none", "jacobi", "ilu0", "ic0", "block_jacobi", "amg"],
    )
    p_solve.add_argument("--tol", type=float, default=1e-8)
    p_solve.add_argument("--max-iter", type=int, default=1000)
    p_solve.add_argument("--out", help="write the solution to this .npy file")
    p_solve.add_argument(
        "--f32", action="store_true",
        help="downcast the system to f32/c64 (half the bytes per SpMV)",
    )
    p_solve.add_argument(
        "--refine", action="store_true",
        help="mixed-precision iterative refinement: f64/c128 accuracy with "
        "--method as the f32/c64 inner solver (max-iter = outer steps)",
    )
    p_solve.set_defaults(fn=_cmd_solve)

    p_eig = sub.add_parser(
        "eig", help="k eigenpairs of a symmetric/Hermitian matrix"
    )
    p_eig.add_argument("matrix", help="Matrix Market file for A")
    p_eig.add_argument("-k", type=int, default=6, help="number of eigenpairs")
    p_eig.add_argument(
        "--which", default=None, choices=["LA", "SA", "LM"],
        help="LA/SA: largest/smallest algebraic (LOBPCG); "
        "LM with --sigma: nearest sigma (shift-invert). "
        "Default: LM when --sigma is given, else SA",
    )
    p_eig.add_argument(
        "--sigma", type=float, default=None,
        help="interior target: return the k eigenvalues nearest this",
    )
    p_eig.add_argument(
        "--interior", default="shift-invert",
        choices=["shift-invert", "rational"],
        help="interior method with --sigma: 'shift-invert' (LOBPCG on "
        "(A-sigma I)^-1, MINRES inner solves) or 'rational' (FEAST-style "
        "contour filter, complex-shifted COCG inner solves — the fast "
        "path when sigma sits deep in a dense spectrum; real-symmetric "
        "matrices only)",
    )
    p_eig.add_argument("--tol", type=float, default=1e-8)
    p_eig.add_argument("--max-iter", type=int, default=200)
    p_eig.add_argument(
        "--precond", default="none", choices=["none", "jacobi", "mg"],
        help="LOBPCG preconditioner (LA/SA only): 'mg' needs --grid and is "
        "the choice at scale (unpreconditioned LOBPCG is gap-limited on "
        "grid operators)",
    )
    p_eig.add_argument(
        "--grid", default=None,
        help="structured grid shape NX[,NY[,NZ]] for --precond mg",
    )
    p_eig.add_argument("--out", help="write w/v to this .npz file")
    p_eig.set_defaults(fn=_cmd_eig)

    args = ap.parse_args(argv)
    # honor the file's dtype: .mtx data is f64/c128 — without x64 JAX would
    # silently truncate (use --f32 to opt into the fast kernel dtypes)
    import jax

    jax.config.update("jax_enable_x64", True)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
