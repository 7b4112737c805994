"""Debugging aids (SURVEY.md §5 "race detection / sanitizers" row).

JAX's functional purity eliminates the reference's aliasing/`unsafe` bug
class; what remains is numerical debugging (NaNs, operator bugs).  Tools:

- :func:`check_operator` — sanity harness for a LinearOperator: linearity,
  matvec/matvec_dot consistency, dtype stability, finiteness.
- NaN hunting: enable ``jax.config.update("jax_debug_nans", True)`` and rerun
  a failing solve; the first NaN-producing primitive raises with a trace.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def check_operator(op, x_example, rtol=None, seed=0):
    """Sanity checks on a LinearOperator. Raises AssertionError on failure.

    ``x_example`` supplies the vector shape/dtype the operator consumes
    (e.g. ``op.pad_vec(jnp.zeros(n))`` for reordered operators).
    """
    rng = np.random.default_rng(seed)
    shape, dtype = x_example.shape, x_example.dtype

    def rand():
        r = rng.standard_normal(shape)
        if jnp.issubdtype(dtype, jnp.complexfloating):
            r = r + 1j * rng.standard_normal(shape)
        return jnp.asarray(r, dtype=dtype)

    if rtol is None:
        rtol = 1e5 * float(jnp.finfo(jnp.finfo(dtype).dtype).eps)

    u, v = rand(), rand()
    a = jnp.asarray(2.5, dtype=dtype)

    yu = op.matvec(u)
    assert yu.shape == u.shape, f"matvec changed shape: {u.shape} -> {yu.shape}"
    assert yu.dtype == dtype, f"matvec changed dtype: {dtype} -> {yu.dtype}"
    finite = jnp.all(jnp.isfinite(jnp.real(yu)))
    if jnp.iscomplexobj(yu):
        finite &= jnp.all(jnp.isfinite(jnp.imag(yu)))
    assert bool(finite), "matvec produced non-finite values"

    # linearity: A(a·u + v) == a·A·u + A·v
    lhs = op.matvec(a * u + v)
    rhs = a * yu + op.matvec(v)
    err = float(jnp.max(jnp.abs(lhs - rhs))) / max(float(jnp.max(jnp.abs(rhs))), 1e-30)
    assert err < rtol, f"matvec not linear: rel err {err:.2e}"

    # matvec_dot consistency
    y2, d = op.matvec_dot(u)
    err_y = float(jnp.max(jnp.abs(y2 - yu)))
    assert err_y == 0.0 or err_y / max(float(jnp.max(jnp.abs(yu))), 1e-30) < rtol, (
        f"matvec_dot y differs from matvec: {err_y:.2e}"
    )
    want = jnp.sum(jnp.conj(u) * yu)
    err_d = abs(complex(d - want)) / max(abs(complex(want)), 1e-30)
    assert err_d < rtol, f"matvec_dot dot mismatch: rel err {err_d:.2e}"
    return True
