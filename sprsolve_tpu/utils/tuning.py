"""Persisted layout-choice cache for ``optimize(measure=True)``.

The ``mkl_sparse_set_mv_hint`` + ``mkl_sparse_optimize`` analog (reference:
``src/mkl_mat.rs:81-148``) taken one step further: the layout that won a
measured comparison PERSISTS across processes, keyed by (device kind, dtype,
sparsity-pattern signature), so the one-time measurement is paid once per
pattern, not per run.

Cache location: ``$SPRSOLVE_TUNE_CACHE`` or
``~/.cache/sprsolve_tpu/autotune.json``.  Writes are atomic
(tmp + rename); a corrupt or unreadable file degrades to the cost model.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np


def _cache_path() -> str:
    p = os.environ.get("SPRSOLVE_TUNE_CACHE")
    if p:
        return p
    return os.path.join(
        os.path.expanduser("~"), ".cache", "sprsolve_tpu", "autotune.json"
    )


_MEM = {"path": None, "mtime": None, "data": {}}


def _load() -> dict:
    path = _cache_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    if _MEM["path"] == path and _MEM["mtime"] == mtime:
        return _MEM["data"]
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}
    _MEM.update(path=path, mtime=mtime, data=data)
    return data


def _save(data: dict) -> None:
    path = _cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    _MEM.update(path=None, mtime=None, data={})  # invalidate the memo


def _device_kind() -> str:
    try:
        import jax

        return jax.devices()[0].device_kind.replace(" ", "_")
    except Exception:
        return "unknown"


# ---------------------------------------------------------------------------
# layout-choice persistence (optimize(measure=True))


def pattern_sig(n: int, nnz: int, indptr, indices) -> str:
    """Stable 16-hex signature of a sparsity pattern (size + sampled
    structure).  Keys the measured-layout cache: re-running the same
    problem skips the measurement pass entirely."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    h.update(np.asarray([n, nnz], np.int64).tobytes())
    ip = np.asarray(indptr, np.int64)
    ix = np.asarray(indices, np.int64)
    h.update(np.ascontiguousarray(ip[:: max(1, len(ip) // 64)]).tobytes())
    h.update(np.ascontiguousarray(ix[:: max(1, len(ix) // 64)]).tobytes())
    return h.hexdigest()


def _layout_key(sig: str, dtype) -> str:
    return f"layout|{_device_kind()}|{np.dtype(dtype).name}|{sig}"


def lookup_layout(sig: str, dtype) -> Optional[str]:
    """The persisted winning layout label for this pattern, or None."""
    ent = _load().get(_layout_key(sig, dtype))
    if isinstance(ent, dict) and "label" in ent:
        return str(ent["label"])
    return None


def store_layout(sig: str, dtype, label: str, gnnz_s: float) -> None:
    data = dict(_load())
    data[_layout_key(sig, dtype)] = {
        "label": str(label),
        "gnnz_s": round(float(gnnz_s), 3),
        "tuned_at": int(time.time()),
    }
    _save(data)


# ---------------------------------------------------------------------------
# measurement


def _time_step(step, x, iters: int) -> float:
    """Chained x ← step(x) inside one dispatch (the loop-carried dependency
    prevents hoisting); returns seconds per apply.  ``step`` must be
    shape-preserving; scale inside it to keep f32 from overflowing."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(v, n_iters):
        def body(_, v):
            return step(v)

        return jax.lax.fori_loop(0, n_iters, body, v, unroll=1)

    jax.block_until_ready(chain(x, jnp.int32(2)))  # compile + warm
    ts = []
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x, jnp.int32(iters)))
        ts.append(time.perf_counter() - t0)
    return max(min(ts) / iters, 1e-12)
