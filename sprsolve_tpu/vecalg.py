"""Dense BLAS-1 vector algebra for the solvers.

Counterpart of the reference's ``src/vecalg.rs`` (842 LoC of
generic-fallback + CBLAS/MKL dual paths).  There is no BLAS to dispatch to:
each primitive is a tiny jnp expression that XLA fuses into neighboring
ops, so the whole module collapses to named functions that keep the solver
code reading like the math.

Semantics parity notes (vs ``src/vecalg.rs``):

- ``dot``        = xᵀy, **no conjugation** (``src/vecalg.rs:19-32``)
- ``conj_dot``   = xᴴy, conjugate-linear in the *first* argument
  (``src/vecalg.rs:34-59``) — this is ``jnp.vdot``'s convention.
- ``norm2``      = sqrt(Σ|xᵢ|²), always real (``src/vecalg.rs:602-605``)
- ``axpy(a,x,y)``  = y + a·x   (``src/vecalg.rs:571-576``)
- ``axpby(a,x,b,y)`` = a·x + b·y (MKL extension, ``src/vecalg.rs:586-591``)
- ``scale``/``rscale`` = a·x with complex/real a (``src/vecalg.rs:593-600``)
- mixed real-scalar × complex-vector is allowed (the reference's
  ``Mul<S, Output=T>`` bound, ``src/vecalg.rs:109-118``) — jnp broadcasting
  gives this for free.

Distributed use: the reduction primitives accept ``axis_name``; when set they
return the *global* value via ``lax.psum`` so the same solver code runs
single-chip and under ``shard_map`` over a device mesh.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax


def _psum_if(x: jax.Array, axis_name: Optional[str]) -> jax.Array:
    return x if axis_name is None else lax.psum(x, axis_name)


def dot(x: jax.Array, y: jax.Array, axis_name: Optional[str] = None) -> jax.Array:
    """xᵀ·y — no conjugation even for complex (``src/vecalg.rs:19-32``)."""
    return _psum_if(jnp.sum(x * y), axis_name)


def conj_dot(x: jax.Array, y: jax.Array, axis_name: Optional[str] = None) -> jax.Array:
    """xᴴ·y — conjugate-linear in x, linear in y (``src/vecalg.rs:34-59``)."""
    return _psum_if(jnp.sum(jnp.conj(x) * y), axis_name)


def abs2(x: jax.Array) -> jax.Array:
    """|x|² elementwise, always real — cauchy ``Scalar::square``."""
    if jnp.iscomplexobj(x):
        return jnp.real(x) ** 2 + jnp.imag(x) ** 2
    return x * x


def norm2_sq(x: jax.Array, axis_name: Optional[str] = None) -> jax.Array:
    """Σ|xᵢ|² (real)."""
    return _psum_if(jnp.sum(abs2(x)), axis_name)


def norm2(x: jax.Array, axis_name: Optional[str] = None) -> jax.Array:
    """‖x‖₂ = sqrt(Σ|xᵢ|²), real (``src/vecalg.rs:602-605``)."""
    return jnp.sqrt(norm2_sq(x, axis_name))


def scale(a: jax.Array, x: jax.Array) -> jax.Array:
    """a·x with scalar a of the vector's dtype (``src/vecalg.rs:593-595``)."""
    return x * a


def rscale(a: jax.Array, x: jax.Array) -> jax.Array:
    """a·x with *real* scalar a on a possibly-complex x (``src/vecalg.rs:597-600``).

    jnp broadcasting already implements ``mul_real``; kept as a named op so
    solver code documents which scalars are known-real.
    """
    return x * a


def conj(x: jax.Array) -> jax.Array:
    """Elementwise conjugate (``src/vecalg.rs:578-584``)."""
    return jnp.conj(x)


def axpy(a: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """y + a·x (``src/vecalg.rs:571-576``). Functional: returns the new y."""
    return y + x * a


def axpby(a: jax.Array, x: jax.Array, b: jax.Array, y: jax.Array) -> jax.Array:
    """a·x + b·y (MKL's axpby extension, ``src/vecalg.rs:586-591``)."""
    return x * a + y * b


def mul_real(z: jax.Array, s: jax.Array) -> jax.Array:
    """z·s with s real — cauchy ``Scalar::mul_real``."""
    return z * s


def real_dtype(dtype) -> jnp.dtype:
    """The real counterpart of a (possibly complex) dtype: T::Real."""
    return jnp.finfo(dtype).dtype if jnp.issubdtype(dtype, jnp.floating) else jnp.real(
        jnp.zeros((), dtype)
    ).dtype


def eps_for(dtype) -> jax.Array:
    """Machine epsilon of the real counterpart of ``dtype`` (T::Real::epsilon())."""
    rdt = real_dtype(jnp.dtype(dtype))
    return jnp.asarray(jnp.finfo(rdt).eps, dtype=rdt)
