"""Multi-device quantitative evidence without the devices.

This tool produces the measurable proxies on a virtual 8-device CPU mesh —
the same shard_map/SPMD-partitioner code path a multi-card mesh compiles:

1. **Comm-volume accounting from the compiled HLO**: bytes moved by
   collective-permute / all-reduce / all-gather per BiCGStab iteration,
   grouped by computation (loop body vs. the rare ρ-restart branch vs.
   setup), cross-checked against the analytic model
   (2 ppermutes × h elements per matvec halo exchange; scalar psums).
2. **Iteration-count invariance** 1 → 8 devices on the 1M-row Poisson:
   the distributed psum changes reduction order, so counts may drift by a
   few iterations; the artifact records the actual counts.
3. **Overlap legality from the HLO data flow**: instructions in the while
   body that do NOT (transitively) depend on any collective-permute result —
   i.e. the local interior compute XLA's latency-hiding scheduler can run
   while the halo is in flight.

Run: python tools/comm_volume.py   (CPU only)
"""

import sys

sys.path.insert(0, "/root/repo")

from sprsolve_tpu.utils.hlo import (
    body_computations,
    collective_summary,
    independent_of_permutes,
    parse_computations,
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import jax.numpy as jnp
    import numpy as np

    import sprsolve_tpu as sp
    from sprsolve_tpu.parallel import distributed_solve
    from sprsolve_tpu.parallel.dist_operator import partition_dia
    from sprsolve_tpu.parallel.solve import make_solver_specs
    from sprsolve_tpu.utils import problems
    from jax.sharding import PartitionSpec as P

    n_side = 100
    A = problems.poisson3d(n_side, n_side, n_side, dtype=np.float32)
    n = A.shape[0]
    dia = A.to_dia()
    h = max(abs(o) for o in dia.offsets)
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal(n).astype(np.float32)
    log(f"poisson3d {n} rows, halo width h = {h}")

    # ---- 1. comm volume from the compiled HLO (8 devices) -------------------
    mesh = jax.make_mesh((8,), ("rows",))
    A_parts = partition_dia(dia, 8, "rows")
    in_specs, out_specs = make_solver_specs(A_parts, None, "rows")

    def run(A_, b_, x_):
        return sp.bicgstab(A_, b_, x_, tol=1e-4, max_iter=400,
                           axis_name="rows")

    sharded = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    ))
    b_pad = jnp.asarray(np.pad(rhs, (0, A_parts.shape[0] - n)))
    x0 = jnp.zeros_like(b_pad)
    compiled = sharded.lower(A_parts, b_pad, x0).compile()
    hlo = compiled.as_text()
    summary = collective_summary(hlo)
    bodies = body_computations(hlo)
    log("\n== collective ops by computation (8-device mesh, BiCGStab) ==")
    per_iter_bytes = 0
    per_iter_detail = {}
    for cname, kinds in sorted(summary.items()):
        tag = " [WHILE BODY → per iteration]" if cname in bodies else ""
        for kind, (cnt, byts) in kinds.items():
            log(f"  {cname}{tag}: {cnt} × {kind}, {byts} B")
            if cname in bodies:
                per_iter_bytes += byts
                per_iter_detail[kind] = per_iter_detail.get(kind, 0) + byts

    # analytic model: 2 matvecs/iter × 2 ppermutes × h × 4 B (per device,
    # both directions counted once each) + scalar all-reduces
    analytic_permute = 2 * 2 * h * 4
    log(f"\nanalytic halo bytes/iter/device: 2 matvecs × 2 ppermutes × "
        f"{h} × 4 B = {analytic_permute} B")
    log(f"HLO while-body collective bytes/iter: {per_iter_bytes} B "
        f"({per_iter_detail})")

    # ---- 2. overlap legality -------------------------------------------------
    comps = parse_computations(hlo)
    log("\n== overlap-legal instruction share in while bodies ==")
    for bname in bodies:
        if bname in comps:
            n_total, n_indep = independent_of_permutes(comps[bname])
            log(f"  {bname}: {n_indep}/{n_total} instructions carry no "
                f"data dependence on any collective-permute (local interior "
                f"work available to overlap the halo exchange)")

    # ---- 3. iteration-count invariance 1 → 8 devices ------------------------
    log("\n== iteration-count invariance (1M rows, tol 1e-4, BiCGStab+Jacobi) ==")
    M = sp.DiagPrecond.new(np.asarray(dia.diagonal()))
    counts = {}
    for nd in (1, 2, 4, 8):
        sub = jax.make_mesh((nd,), ("rows",), devices=jax.devices()[:nd])
        x, info = distributed_solve(
            sp.bicgstab, dia, jnp.asarray(rhs), M=M, tol=1e-4, max_iter=400,
            mesh=sub,
        )
        r = np.asarray(A.matvec(jnp.asarray(np.asarray(x)))) - rhs
        rel = float(np.linalg.norm(r) / np.linalg.norm(rhs))
        counts[nd] = int(info.iterations)
        log(f"  {nd} device(s): {int(info.iterations)} iters, "
            f"true rel res {rel:.2e}")
    spread = max(counts.values()) - min(counts.values())
    log(f"  spread across device counts: {spread} iterations "
        f"(psum reduction-order effect)")

    # ---- 4. 10M-row invariance (COMM_LARGE=1; minutes of CPU time) ----------
    import os

    if os.environ.get("COMM_LARGE") == "1":
        log("\n== 10M-row iteration-count invariance (tol 1e-4) ==")
        A10 = problems.poisson3d(216, 216, 216, dtype=np.float32)
        dia10 = A10.to_dia()
        rhs10 = np.random.default_rng(1).standard_normal(
            A10.shape[0]
        ).astype(np.float32)
        M10 = sp.DiagPrecond.new(np.asarray(dia10.diagonal()))
        counts10 = {}
        for nd in (1, 4, 8):
            sub = jax.make_mesh((nd,), ("rows",), devices=jax.devices()[:nd])
            x, info = distributed_solve(
                sp.bicgstab, dia10, jnp.asarray(rhs10), M=M10, tol=1e-4,
                max_iter=400, mesh=sub,
            )
            counts10[nd] = int(info.iterations)
            log(f"  {nd} device(s): {int(info.iterations)} iters, "
                f"rel res {float(info.residual):.2e}")
        log(f"  spread: {max(counts10.values()) - min(counts10.values())}")


if __name__ == "__main__":
    main()
