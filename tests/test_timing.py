"""The shared measurement helpers: the device peak table and the
persistent compilation cache placement."""

import os

import jax
import pytest

from sprsolve_tpu.utils import timing


def test_peak_table_lists_h100_with_source():
    p = timing.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["hbm_bytes"] == 80e9
    assert "data sheet" in p["source"]
    for ent in timing.PEAKS.values():
        assert ent["hbm_bytes_per_s"] > 0 and ent["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        timing.device_peaks(kind)


def test_default_device_on_cpu_raises():
    """The CPU test backend is not a measurable device: no default peak."""
    with pytest.raises(KeyError):
        timing.device_peaks()


def test_spmv_report_refuses_unknown_device():
    rep = timing.spmv_report(1e-3, 1000, 8000)
    with pytest.raises(KeyError):
        rep.roofline_fraction
    known = timing.SpmvReport(1e-3, 1000, 3.35e9, "NVIDIA H100 80GB HBM3")
    assert known.roofline_fraction == pytest.approx(1.0)  # 3.35 GB in 1 ms


def test_compile_cache_env_var_wins(tmp_path, monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert timing.enable_compile_cache(str(tmp_path)) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == prev  # nothing set in code


def test_compile_cache_fixed_path_when_unset(tmp_path, monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = timing.enable_compile_cache(str(tmp_path))
        assert got == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        # the same root always gives the same path (the cache key)
        assert timing.enable_compile_cache(str(tmp_path)) == got
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
