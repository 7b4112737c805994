"""Test configuration.

Mirrors the reference test strategy (SURVEY.md §4): deterministic, CPU-only,
single-process. Multi-device logic is tested on a virtual 8-device CPU mesh
(``jax_num_cpu_devices``) — the JAX-native analog of a fake backend —
exercising the same shard_map code paths that run on a multi-GPU mesh.

f64/c128 are enabled because the reference tolerances (1e-17, 1e-22) require
x64 arithmetic; the f32 card paths are checked on the GPU by
``chip_smoke.py`` and the ``gpu``-marked tests.

The platform is forced to CPU before any backend initializes.  Tests marked
``gpu`` need an NVIDIA GPU and skip here through the ``gpu_device`` fixture,
which decides at run time, never at import: run them on a card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

import jax
import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, so every
    worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    return gpus[0]
