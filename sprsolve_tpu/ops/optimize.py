"""Operator optimization: pick the best execution layout for a matrix.

The analog of MKL's inspector-executor flow (``mkl_sparse_set_mv_hint`` +
``mkl_sparse_optimize``, ``src/mkl_mat.rs:81-148``): analyze the pattern once
at construction, then every SpMV runs in the chosen layout.

Decision procedure (native hostkit analysis, O(nnz)), in order:

1. few distinct diagonals → :class:`DIA` (XLA shifted slices, every dtype;
   XLA fuses the bands into one pass and the card's L2 serves the shifted
   re-reads of x), with f32 bands stored in the narrowest exact dtype
   (:meth:`DIA.narrow`).
2. otherwise RCM-reorder and recount: banded-after-RCM matrices run the same
   DIA path wrapped in :class:`~sprsolve_tpu.ops.reordered.Reordered`
   (permutations only at the solve boundary).
3. otherwise compare wide DIA, BSR (dense-block batched products;
   :class:`ComplexBSR` for complex data), and the band+outlier
   :class:`~sprsolve_tpu.ops.hybrid.HybridDIA` split (banded core + a priced
   COO sidecar for a small spill) — on both the original and the RCM
   pattern — ranked by predicted *time* (bytes/nnz ÷ measured per-path
   share of the HBM peak; the sidecar priced at the measured gather+scatter
   rate), taking the fastest that fits the memory budget.
4. ELL (row-padded gather) as the last resort, with a RuntimeWarning.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np

from ..native import csr_count_diagonals
from ..sparse.bsr import BSR, ComplexBSR
from ..sparse.containers import CSR, DIA, ELL, reorder_rcm
from .hybrid import HybridDIA
from .reordered import Reordered

# block sizes tried by the BSR cost model; smaller sizes trade dense-block
# efficiency for less zero-fill on scattered patterns
_BSR_SIZES = (128, 64, 32, 16, 8)

# Measured share of the HBM peak each execution path reaches (NVIDIA H100
# 80GB HBM3 at a 400 W limit;
# model bytes per SpMV over time, at sizes past the 50 MB L2 — PERF.md
# "Routing constants").  The cost model ranks candidates by
# bytes_per_nnz / share, i.e. by predicted TIME; pure-byte ranking picks
# the slower path when two layouts run at very different shares.
EFF_XLA_DIA = 0.66
EFF_BSR = 0.64

# effective-bytes price of ONE outlier element in the hybrid sidecar
# (gather of x + scatter-add into y): HBM peak bytes/s ÷ measured elements/s,
# so that score·nnz / peak is a time like the byte scores (PERF.md).
SCATTER_BYTES_EQ = 585.0


def band_min_count(n_rows: int, itemsize: int) -> int:
    """Fewest entries an offset needs to earn its full n-length band: a band
    streams n·itemsize bytes at the DIA share of the peak, one sidecar entry
    costs SCATTER_BYTES_EQ — below this count the offset is cheaper spilled.
    Shared by the cost model and :meth:`HybridDIA.from_csr`."""
    return max(4, int(n_rows * itemsize / EFF_XLA_DIA / SCATTER_BYTES_EQ))


def _hybrid_stats(m: CSR, max_diags: int):
    """(core diag count, outlier count) of the heaviest-offsets split —
    the same band-earns-its-stream selection HybridDIA.from_csr applies."""
    rows = np.asarray(m.row_ids, np.int64)
    cols = np.asarray(m.indices, np.int64)
    _, counts = np.unique(cols - rows, return_counts=True)
    counts = np.sort(counts)[::-1]
    itemsize = np.dtype(np.asarray(m.data).dtype).itemsize
    min_count = band_min_count(m.shape[0], itemsize)
    kept = counts[counts >= min_count][:max_diags]
    return max(len(kept), 1), int(m.nnz - kept.sum())


def _bsr_cost(m: CSR, itemsize: int, mem_limit: int):
    """(bytes_per_nnz, bs) of the cheapest BSR blocking, or (inf, 0)."""
    best = (float("inf"), 0)
    nnz = m.nnz
    for bs in _BSR_SIZES:
        nblk = BSR.estimate_blocks(m, bs)
        mem = nblk * bs * bs * itemsize
        if mem > mem_limit:
            continue
        # traffic per SpMV: blocks + gathered x blocks + row-summed products
        bpn = (nblk * (bs * bs + 2 * bs) * itemsize) / nnz
        if bpn < best[0]:
            best = (bpn, bs)
    return best


def optimize(
    m: CSR,
    *,
    max_diags: int = 32,
    allow_reorder: bool = True,
    allow_bsr: bool = True,
    allow_hybrid: bool = True,
    wide_diags: int = 192,
    mem_limit_bytes: int = 4 << 30,
    measure: bool = False,
    measure_iters: int = 30,
):
    """Analyze ``m`` and return the fastest operator for repeated SpMV.

    Returns one of DIA / BSR / ComplexBSR / HybridDIA, possibly wrapped in
    :class:`Reordered`, or ELL as the warned last resort.  The returned
    operator satisfies the LinearOperator protocol; operators exposing
    ``pad_vec``/``unpad_vec`` work in their own internal vector layout
    (``solve()`` handles the conversion).

    ``max_diags`` bounds the banded DIA band count; ``wide_diags`` bounds the
    XLA-DIA fallback used when the band is wide but still far cheaper than
    gathering; ``mem_limit_bytes`` caps any layout's storage blow-up.

    ``measure=True`` settles the wide-DIA/BSR comparison empirically instead
    of by the efficiency-weighted byte model: every surviving candidate is
    built, its SpMV timed on the current backend (``measure_iters`` chained
    applies), and the measured winner returned — the full
    ``mkl_sparse_set_mv_hint(calls) + mkl_sparse_optimize`` flow
    (``src/mkl_mat.rs:81-148``), worth its one-time cost when the operator
    is applied many times.  The winning label persists in the autotune cache
    keyed by the sparsity-pattern signature, so re-running the same problem
    skips the measurement pass.  (Banded matrices short-circuit to DIA.)
    """
    n = m.shape[0]
    nnz = m.nnz
    itemsize = np.dtype(m.data.dtype).itemsize
    indptr = np.asarray(m.indptr, np.int64)
    indices = np.asarray(m.indices, np.int32)

    n_diags = csr_count_diagonals(n, indptr, indices)
    if n_diags <= max_diags:
        return DIA.from_csr(m, max_diags=max_diags).narrow()

    mp = perm = None
    nd_perm = n_diags
    if allow_reorder:
        mp, perm = reorder_rcm(m)
        nd_perm = csr_count_diagonals(
            n, np.asarray(mp.indptr, np.int64), np.asarray(mp.indices, np.int32)
        )
        if nd_perm <= max_diags and nd_perm * n * itemsize <= mem_limit_bytes:
            return Reordered.wrap(
                DIA.from_csr(mp, max_diags=max_diags).narrow(), perm
            )

    # cost-model comparison: wide XLA-DIA vs BSR, original vs RCM pattern.
    # Candidates are ranked by PREDICTED TIME — bytes_per_nnz divided by the
    # measured per-path share of the HBM peak — not by raw bytes.
    is_complex = bool(jnp.iscomplexobj(m.data))
    candidates = []  # (bytes_per_nnz / efficiency, label, builder)
    for cand_m, cand_perm, nd, tag in (
        (m, None, n_diags, ""), (mp, perm, nd_perm, "-rcm")
    ):
        if cand_m is None:
            continue
        if nd <= wide_diags and nd * n * itemsize <= mem_limit_bytes:
            bpn = (nd + 2) * n * itemsize / nnz
            candidates.append(
                (bpn / EFF_XLA_DIA, f"dia{nd}{tag}",
                 lambda cm=cand_m, cp=cand_perm, nd=nd: _wrap(
                     DIA.from_csr(cm, max_diags=nd), cp
                 ))
            )
        if allow_bsr:
            bpn, bs = _bsr_cost(cand_m, itemsize, mem_limit_bytes)
            if bs:
                blk_cls = ComplexBSR if is_complex else BSR
                candidates.append(
                    (bpn / EFF_BSR, f"bsr{bs}{tag}",
                     lambda cm=cand_m, cp=cand_perm, bs=bs, cls=blk_cls: _wrap(
                         cls.from_csr(cm, bs=bs), cp
                     ))
                )
        if allow_hybrid:
            # band+outlier split: the heaviest max_diags offsets become a
            # DIA core and the spill a priced COO sidecar — closes the cliff
            # where a handful of long-range entries used to disqualify the
            # whole banded fast path
            nd_core, n_out = _hybrid_stats(cand_m, max_diags)
            cap = max(4096, nnz // 100)
            if 0 < n_out <= cap:
                bpn_core = (nd_core + 2) * n * itemsize / nnz
                score = (
                    bpn_core / EFF_XLA_DIA + SCATTER_BYTES_EQ * n_out / nnz
                )
                candidates.append(
                    (score, f"hybrid{nd_core}+{n_out}{tag}",
                     lambda cm=cand_m, cp=cand_perm: _wrap(
                         HybridDIA.from_csr(
                             cm, max_diags=max_diags,
                             max_outliers=cap,
                         ), cp
                     ))
                )
    if len(candidates) > 1 and measure:
        picked = _measure_pick(m, candidates, measure_iters)
        if picked is not None:
            return picked
    if candidates:
        score, _label, build = min(candidates, key=lambda c: c[0])
        return build()

    warnings.warn(
        f"optimize(): no structured layout found ({n_diags} diagonals, "
        "no block/band structure within the memory budget); falling back to "
        "the ELL gather path, which pads every row to the longest one. "
        "Consider a reordering or a coarser preconditioner strategy.",
        RuntimeWarning,
        stacklevel=2,
    )
    return ELL.from_csr(m)


def _wrap(inner, perm):
    return inner if perm is None else Reordered.wrap(inner, perm)


def _layout_step(inner, n, scale):
    """(step, x0) for timing one candidate's SpMV as a shape-preserving
    chain."""
    rng = np.random.default_rng(0)
    dt = np.dtype(inner.dtype)
    x = rng.standard_normal(n)
    if dt.kind == "c":
        x = x + 1j * rng.standard_normal(n)
    return (lambda v: inner.matvec(v) * scale), jnp.asarray(x.astype(dt))


def _measure_pick(m: CSR, candidates, iters: int):
    """Time each candidate layout's SpMV on the current backend and return
    the built winner (None → fall back to the cost model).  The winning
    label persists keyed by the pattern signature + dtype + device kind."""
    from ..utils import tuning

    n, nnz = m.shape[0], m.nnz
    data = np.asarray(m.data)
    sig = tuning.pattern_sig(n, nnz, m.indptr, m.indices)
    by_label = {label: build for _s, label, build in candidates}
    cached = tuning.lookup_layout(sig, data.dtype)
    if cached in by_label:
        return by_label[cached]()
    # chain stability: bound the spectral radius estimate by ||A||_inf's
    # cheap upper bound so 'iters' chained applies cannot overflow f32
    rows_max = int(np.diff(np.asarray(m.indptr)).max()) if n else 1
    ainf_ub = float(np.abs(data).max()) * max(rows_max, 1) if len(data) else 1.0
    scale = 0.5 / max(ainf_ub, 1e-30)
    best = None
    for _score, label, build in candidates:
        try:
            op = build()
            inner = op.inner if isinstance(op, Reordered) else op
            step, x = _layout_step(inner, n, scale)
            t = tuning._time_step(step, x, iters)
        except Exception:
            continue  # unbuildable/unmeasurable on this backend: skip
        if best is None or t < best[0]:
            best = (t, label, op)
    if best is None:
        return None
    t, label, op = best
    tuning.store_layout(sig, data.dtype, label, nnz / t / 1e9)
    return op
