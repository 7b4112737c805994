"""Timing / profiling / roofline harness, shared by ``bench.py`` and
``chip_smoke.py``.

The reference's only perf instrumentation is criterion benches and MKL hint
calls (SURVEY.md §5 "Tracing/profiling: none in-library").  Here:

- :data:`PEAKS` / :func:`device_peaks` — the one table of published device
  peaks, keyed by ``device_kind``; an unknown device is an error, never a
  default.
- :func:`enable_compile_cache` — the persistent compilation cache placement.
- :func:`time_fn` — wall timing of a jitted callable, ended by
  ``block_until_ready``.
- :func:`spmv_report` — nnz/s + achieved bandwidth + share of the HBM peak.
- :func:`trace` — context manager around ``jax.profiler`` for on-demand
  device traces.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable

import jax

# Published per-card peaks (NVIDIA H100 data sheet; dense rates, full power
# limit).  Keyed by ``jax.devices()[0].device_kind``.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "hbm_bytes": 80e9,
        "source": "NVIDIA H100 data sheet, SXM5: 3.35 TB/s HBM3, 80 GB",
    },
    "NVIDIA H100 PCIe": {
        "hbm_bytes_per_s": 2.0e12,
        "hbm_bytes": 80e9,
        "source": "NVIDIA H100 data sheet, PCIe: 2.0 TB/s HBM2e, 80 GB",
    },
}


def device_peaks(kind: str | None = None) -> dict:
    """Peaks of ``kind`` (default: the first JAX device).  Raises ``KeyError``
    for a device the table does not list — a rate divided by a guessed peak
    is not a measurement."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add it to "
            "sprsolve_tpu.utils.timing.PEAKS with its source"
        ) from None


def enable_compile_cache(root: str) -> str:
    """Use a persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache is the fixed path
    ``<root>/.jax_cache`` — ``root`` is the calling script's own directory,
    so the path (part of the cache's key) is the same on every run."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Mean seconds per call after warmup, one dispatch per call, ended by
    ``block_until_ready``. For sub-ms kernels prefer chaining inside one
    jit."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@dataclass
class SpmvReport:
    seconds: float
    nnz: int
    bytes_algorithmic: int
    device_kind: str

    @property
    def gnnz_per_s(self) -> float:
        return self.nnz / self.seconds / 1e9

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_algorithmic / self.seconds / 1e9

    @property
    def roofline_fraction(self) -> float:
        peak = device_peaks(self.device_kind)["hbm_bytes_per_s"]
        return self.achieved_gbps * 1e9 / peak

    def __str__(self) -> str:
        return (
            f"SpMV: {self.seconds*1e3:.3f} ms, {self.gnnz_per_s:.2f} Gnnz/s, "
            f"{self.achieved_gbps:.0f} GB/s "
            f"({100*self.roofline_fraction:.0f}% of the {self.device_kind} "
            "HBM peak)"
        )


def dia_bytes(n: int, n_diags: int, itemsize: int = 4) -> int:
    """Algorithmic-minimum traffic for a DIA SpMV: bands + x + y once each."""
    return (n_diags * n + 2 * n) * itemsize


def ell_bytes(n: int, k: int, itemsize: int = 4) -> int:
    """ELL SpMV: data + int32 cols + x + y."""
    return (k * n) * (itemsize + 4) + 2 * n * itemsize


def spmv_report(seconds: float, nnz: int, bytes_algorithmic: int) -> SpmvReport:
    return SpmvReport(
        seconds=seconds,
        nnz=nnz,
        bytes_algorithmic=bytes_algorithmic,
        device_kind=jax.devices()[0].device_kind,
    )


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``with trace(): run_solve()`` → device trace viewable in XProf."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "sprsolve_tpu_trace")
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
