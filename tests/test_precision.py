"""Every f32 matmul in the three sites that once set no precision lowers at
HIGHEST: a default-precision f32 dot may run in TF32 (~3 decimal digits) on
the GPU, which a solver's matvec or projection cannot afford."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from sprsolve_tpu.ops.operator import as_operator
from sprsolve_tpu.parallel import partition_csr
from sprsolve_tpu.solvers import idrs
from sprsolve_tpu.utils import problems


def _lowered(site: str) -> str:
    A = problems.grid_laplacian_dirichlet((8, 8), dtype=np.float32)
    if site == "idrs":
        b = jnp.ones(64, jnp.float32)
        with pytest.warns(RuntimeWarning):  # idrs's cost-model note
            return jax.jit(
                lambda a, v: idrs(a, v, tol=1e-6, max_iter=20)
            ).lower(A.to_dia(), b).as_text()
    if site == "dense_operator":
        D = as_operator(jnp.asarray(np.random.default_rng(0).random((8, 8)),
                                    jnp.float32))
        return jax.jit(lambda d, v: d.matvec(v)).lower(
            D, jnp.ones(8, jnp.float32)).as_text()
    op = partition_csr(A, 4)
    mesh = jax.make_mesh((4,), ("rows",), devices=jax.devices()[:4])
    f = jax.jit(jax.shard_map(
        lambda o, X: o.matmat(X), mesh=mesh,
        in_specs=(op.pspec("rows"), P("rows", None)),
        out_specs=P("rows", None), check_vma=False,
    ))
    return f.lower(op, jnp.ones((64, 3), jnp.float32)).as_text()


@pytest.mark.parametrize("site", ["idrs", "dense_operator", "allgather_ell_matmat"])
def test_matmul_sites_lower_at_highest(site):
    dots = [ln for ln in _lowered(site).splitlines() if "dot_general" in ln]
    assert dots, site
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln
