"""Persisted layout-choice cache of ``optimize(measure=True)``: key
separation, round-trip, robustness to a corrupt cache file, and the chained
timing step.  Uses tiny matrices — this tests the machinery, not
performance claims (those are measured on the card)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from sprsolve_tpu.utils import problems, tuning


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("SPRSOLVE_TUNE_CACHE", path)
    tuning._MEM.update(path=None, mtime=None, data={})
    yield path
    tuning._MEM.update(path=None, mtime=None, data={})


def _csr(side=12):
    return problems.grid_laplacian_dirichlet((side, side), dtype=np.float32)


def test_layout_persists_and_resolves(cache):
    A = _csr()
    sig = tuning.pattern_sig(A.shape[0], A.nnz, A.indptr, A.indices)
    assert tuning.lookup_layout(sig, np.float32) is None
    tuning.store_layout(sig, np.float32, "bsr32", 12.5)
    assert tuning.lookup_layout(sig, np.float32) == "bsr32"
    (key, ent), = json.load(open(cache)).items()
    assert key.startswith("layout|") and sig in key
    assert ent["label"] == "bsr32" and ent["gnnz_s"] == 12.5


def test_dtype_and_pattern_keys_are_separate(cache):
    A, B = _csr(12), _csr(13)
    sa = tuning.pattern_sig(A.shape[0], A.nnz, A.indptr, A.indices)
    sb = tuning.pattern_sig(B.shape[0], B.nnz, B.indptr, B.indices)
    assert sa != sb
    assert sa == tuning.pattern_sig(A.shape[0], A.nnz, A.indptr, A.indices)
    tuning.store_layout(sa, np.float32, "dia5", 1.0)
    assert tuning.lookup_layout(sa, np.float64) is None
    assert tuning.lookup_layout(sb, np.float32) is None


def test_corrupt_cache_degrades_to_no_entry(cache):
    with open(cache, "w") as f:
        f.write("{not json")
    tuning._MEM.update(path=None, mtime=None, data={})
    assert tuning.lookup_layout("0" * 16, np.float32) is None
    tuning.store_layout("0" * 16, np.float32, "ell", 0.1)  # rewrites cleanly
    assert tuning.lookup_layout("0" * 16, np.float32) == "ell"


def test_time_step_is_positive_per_apply():
    dia = _csr().to_dia()
    x = jnp.ones(dia.shape[0], jnp.float32)
    t = tuning._time_step(lambda v: dia.matvec(v) * jnp.float32(0.125), x, 5)
    assert 0 < t < 10.0
