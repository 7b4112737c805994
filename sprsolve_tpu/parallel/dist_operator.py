"""Row-partitioned distributed operators (the SP-like axis of this library).

Each device in a 1-D mesh owns a contiguous block of matrix rows and the
matching block of every solver vector (SURVEY.md §5: "row-partition the matrix
across chips, each chip holding a block of rows + the halo entries of x its
columns touch").  Two execution strategies:

- :class:`AllGatherELL` — general sparsity: the x vector is all-gathered over
  the mesh axis, local rows then do a plain ELL SpMV against the full vector.
  Bandwidth cost O(n) per step but works for any pattern; XLA lowers the
  all-gather onto ICI.
- :class:`HaloDIA` — banded/stencil matrices: only boundary slices of width
  h = max|offset| move, via neighbor ``ppermute``.  The halo exchange is
  expressed as separate data flow from the interior band products so XLA can
  overlap the permute with local compute — structurally the ring-attention
  overlap trick applied to SpMV.

Both are pytrees; ``pspec(axis)`` returns the matching tree of PartitionSpecs
for ``shard_map`` in_specs.  Row blocks are padded with identity rows (and
zero rhs entries) to make n divisible by the mesh size — zeros propagate
through every Krylov recurrence, so padding is exact, not approximate.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from ..sparse.containers import CSR, DIA, ELL


def auto_mesh(mesh, axis_name: str):
    """A 1-D mesh with AUTO axis types for the manual ``shard_map`` drivers.

    ``jax.make_mesh`` defaults to EXPLICIT axis types, under which a
    replicated closure constant batched inside a manual shard_map body trips
    an XLA sharding-override assertion (seen with ``vmap``-of-``minres``
    inside :func:`~sprsolve_tpu.parallel.distributed_shift_invert_eigs`).
    The drivers here use shard_map in fully-manual mode, so Auto axes are
    the correct typing; a user-supplied Explicit mesh is rebuilt with the
    same devices.
    """
    from jax.sharding import AxisType, Mesh

    if mesh is None:
        devices = jax.devices()
        return jax.make_mesh(
            (len(devices),), (axis_name,), devices=devices,
            axis_types=(AxisType.Auto,),
        )
    if all(t == AxisType.Auto for t in mesh.axis_types):
        return mesh
    return Mesh(
        mesh.devices, mesh.axis_names,
        axis_types=(AxisType.Auto,) * len(mesh.axis_names),
    )


@dataclasses.dataclass(frozen=True)
class AllGatherELL:
    """Local row-block ELL over an all-gathered x. General sparsity."""

    data: jax.Array   # (n_pad, k) globally / (rows_per_device, k) inside shard_map
    cols: jax.Array   # same shape, *global* column ids
    shape: Tuple[int, int]
    axis_name: str

    @property
    def dtype(self):
        return self.data.dtype

    def pspec(self, axis_name=None) -> "AllGatherELL":
        a = axis_name or self.axis_name
        return AllGatherELL(
            data=P(a, None), cols=P(a, None), shape=self.shape, axis_name=self.axis_name
        )

    def matvec(self, x_local: jax.Array) -> jax.Array:
        x_full = lax.all_gather(x_local, self.axis_name, axis=0, tiled=True)
        return jnp.sum(self.data * jnp.take(x_full, self.cols, axis=0), axis=1)

    def matvec_dot(self, x_local: jax.Array):
        # returns the LOCAL partial dot; solvers psum it over the axis.
        from ..vecalg import conj_dot

        y = self.matvec(x_local)
        return y, conj_dot(x_local, y)

    def matmat(self, X_local: jax.Array) -> jax.Array:
        """Block SpMM A·X for an (m, k) local block — ONE all-gather covers
        all k columns (the distributed-LOBPCG workhorse; a per-column
        ``matvec`` loop would pay k gathers of the same x traffic)."""
        X_full = lax.all_gather(X_local, self.axis_name, axis=0, tiled=True)
        # (rows, kk, k) gathered operand against (rows, kk) values — a
        # contraction over the ELL slot axis; HIGHEST because a default-
        # precision f32 einsum may run in TF32 (~3 decimal digits)
        return jnp.einsum(
            "re,rek->rk", self.data, jnp.take(X_full, self.cols, axis=0),
            precision=lax.Precision.HIGHEST,
        )


jax.tree_util.register_dataclass(
    AllGatherELL, data_fields=("data", "cols"), meta_fields=("shape", "axis_name")
)


@dataclasses.dataclass(frozen=True)
class HaloDIA:
    """Local row-block DIA with neighbor halo exchange. Banded matrices only.

    Requires max|offset| ≤ rows_per_device. Band values are stored at row
    index (global layout sliced by rows), so a device's band block already
    matches its row block.
    """

    bands: jax.Array          # (n_diags, n_pad) globally / (n_diags, m) locally
    offsets: Tuple[int, ...]  # static
    shape: Tuple[int, int]
    axis_name: str

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    def pspec(self, axis_name=None) -> "HaloDIA":
        a = axis_name or self.axis_name
        return HaloDIA(
            bands=P(None, a),
            offsets=self.offsets,
            shape=self.shape,
            axis_name=self.axis_name,
        )

    def matvec(self, x_local: jax.Array) -> jax.Array:
        ax = self.axis_name
        m = x_local.shape[0]
        h = self.halo
        nd = lax.axis_size(ax)

        # Neighbor halo exchange: device i receives the first h entries of
        # device i+1 (right halo) and the last h of device i-1 (left halo).
        # ppermute leaves unmatched destinations zero — exactly the boundary
        # condition (out-of-range x reads as 0, matching the zero band values
        # DIA construction guarantees there).
        right_halo = lax.ppermute(
            x_local[:h], ax, perm=[(i, (i - 1) % nd) for i in range(1, nd)]
        )
        left_halo = lax.ppermute(
            x_local[m - h :], ax, perm=[(i, (i + 1) % nd) for i in range(nd - 1)]
        )

        # Interior contributions first (pure local data flow) so XLA can
        # overlap the two ppermutes with this compute.
        y = jnp.zeros(m, dtype=jnp.result_type(self.dtype, x_local.dtype))
        zero = jnp.zeros((), x_local.dtype)
        for d, off in enumerate(self.offsets):
            if off == 0:
                y = y + self.bands[d] * x_local
            elif off > 0:
                local = jnp.concatenate([x_local[off:], jnp.zeros(off, x_local.dtype)])
                y = y + self.bands[d] * local
            else:
                local = jnp.concatenate([jnp.zeros(-off, x_local.dtype), x_local[:off]])
                y = y + self.bands[d] * local

        # Halo corrections: rows within h of the block boundary pick up the
        # neighbor entries the interior pass zero-filled.
        for d, off in enumerate(self.offsets):
            if off > 0:
                # rows m-off..m read x_global[i+off] from the right neighbor
                corr = self.bands[d, m - off :] * right_halo[:off]
                y = y.at[m - off :].add(corr)
            elif off < 0:
                corr = self.bands[d, : -off] * left_halo[h + off :]
                y = y.at[: -off].add(corr)
        return y

    def matvec_dot(self, x_local: jax.Array):
        from ..vecalg import conj_dot

        y = self.matvec(x_local)
        return y, conj_dot(x_local, y)

    def matmat(self, X_local: jax.Array) -> jax.Array:
        """Block SpMM A·X for an (m, k) local block — ONE halo exchange
        covers all k columns (two ppermutes of (h, k) slabs, vs 2k for a
        per-column ``matvec`` loop).  Same interior-first data flow as
        ``matvec`` so XLA overlaps the permutes with the band products."""
        ax = self.axis_name
        m = X_local.shape[0]
        h = self.halo
        nd = lax.axis_size(ax)
        tail = X_local.shape[1:]

        right_halo = lax.ppermute(
            X_local[:h], ax, perm=[(i, (i - 1) % nd) for i in range(1, nd)]
        )
        left_halo = lax.ppermute(
            X_local[m - h :], ax, perm=[(i, (i + 1) % nd) for i in range(nd - 1)]
        )

        def zrows(r):
            return jnp.zeros((r,) + tail, X_local.dtype)

        Y = jnp.zeros(
            (m,) + tail, dtype=jnp.result_type(self.dtype, X_local.dtype)
        )
        for d, off in enumerate(self.offsets):
            band = self.bands[d][:, None]
            if off == 0:
                Y = Y + band * X_local
            elif off > 0:
                Y = Y + band * jnp.concatenate([X_local[off:], zrows(off)])
            else:
                Y = Y + band * jnp.concatenate([zrows(-off), X_local[:off]])
        for d, off in enumerate(self.offsets):
            if off > 0:
                corr = self.bands[d, m - off :][:, None] * right_halo[:off]
                Y = Y.at[m - off :].add(corr)
            elif off < 0:
                corr = self.bands[d, : -off][:, None] * left_halo[h + off :]
                Y = Y.at[: -off].add(corr)
        return Y


jax.tree_util.register_dataclass(
    HaloDIA, data_fields=("bands",), meta_fields=("offsets", "shape", "axis_name")
)


def _padded_rows(n: int, n_devices: int) -> int:
    return (n + n_devices - 1) // n_devices * n_devices


def partition_csr(m: CSR, n_devices: int, axis_name: str = "rows") -> AllGatherELL:
    """CSR → row-padded global ELL ready to shard over ``axis_name``.

    Pad rows are identity (a_ii = 1) so the padded system block-decouples;
    with zero rhs padding the extra coordinates stay exactly 0.
    """
    ell = ELL.from_csr(m)
    n = m.shape[0]
    n_pad = _padded_rows(n, n_devices)
    if n_pad != n:
        extra = n_pad - n
        pad_data = np.zeros((extra, ell.k), dtype=np.asarray(ell.data).dtype)
        pad_cols = np.zeros((extra, ell.k), dtype=np.int32)
        pad_data[:, 0] = 1.0
        pad_cols[:, 0] = np.arange(n, n_pad)
        data = jnp.concatenate([ell.data, jnp.asarray(pad_data)])
        cols = jnp.concatenate([ell.cols, jnp.asarray(pad_cols)])
    else:
        data, cols = ell.data, ell.cols
    return AllGatherELL(
        data=data, cols=cols, shape=(n_pad, n_pad), axis_name=axis_name
    )


def partition_dia(m: DIA, n_devices: int, axis_name: str = "rows") -> HaloDIA:
    """DIA → row-padded global banded layout ready to shard over ``axis_name``."""
    n = m.shape[0]
    n_pad = _padded_rows(n, n_devices)
    if 0 not in m.offsets:
        raise ValueError("partition_dia requires a stored main diagonal")
    bands = np.asarray(m.bands)
    if n_pad != n:
        pad = np.zeros((bands.shape[0], n_pad - n), dtype=bands.dtype)
        pad[m.offsets.index(0), :] = 1.0  # identity pad rows
        bands = np.concatenate([bands, pad], axis=1)
    h = max(abs(o) for o in m.offsets)
    if h > n_pad // n_devices:
        raise ValueError(
            f"bandwidth {h} exceeds rows-per-device {n_pad // n_devices}; "
            "use AllGatherELL or fewer devices"
        )
    return HaloDIA(
        bands=jnp.asarray(bands),
        offsets=m.offsets,
        shape=(n_pad, n_pad),
        axis_name=axis_name,
    )


@dataclasses.dataclass(frozen=True)
class MPKDIA:
    """HaloDIA plus per-device EXTENDED band windows: the matrix-powers
    kernel operator for s-step (communication-avoiding) Krylov methods.

    Each device stores the bands of its row block AND of ``ext`` rows on
    each side (``bands_ext``), so a single depth-``ext`` halo exchange of a
    vector (``mpk_extend``) lets it apply A locally ``ext // halo`` times
    (``mpk_apply``): application ℓ is exact on extended-window rows
    [ℓ·h, L − ℓ·h), which contains the central row block as long as
    ℓ·h ≤ ext.  Out-of-range rows read x = 0 and carry zero band values —
    exactly the DIA boundary convention — so the global edges need no
    special casing.  That turns the 2·s ``ppermute``s of s plain SpMVs
    into 2 (one exchange for the whole power chain): the ICI-latency
    amortization that pays for CA-CG (`solvers.ca_cg`).

    Bandwidth trade: the exchange moves ``ext = s·h`` rows per side instead
    of h, and each of the s local applications works on m + 2·ext rows —
    both O(s·h/m) overheads, negligible while s·h ≪ m.

    ``bands_ext`` is (n_diags, n_devices, m + 2·ext) globally and
    (n_diags, 1, m + 2·ext) per device (``pspec`` shards axis 1); plain
    matvec/matmat delegate to a :class:`HaloDIA` view of the central
    columns, so every ordinary solver runs on this operator unchanged.
    """

    bands_ext: jax.Array      # (n_diags, nd, m+2E) global / (n_diags, 1, m+2E) local
    offsets: Tuple[int, ...]  # static
    shape: Tuple[int, int]    # padded global
    axis_name: str
    ext: int                  # static: E = s_max · halo, rows per side

    @property
    def dtype(self):
        return self.bands_ext.dtype

    @property
    def halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    @property
    def max_power(self) -> int:
        """Exact local applications per exchange (ext // halo)."""
        h = self.halo
        return self.ext // h if h else 1 << 30

    def pspec(self, axis_name=None) -> "MPKDIA":
        a = axis_name or self.axis_name
        return MPKDIA(
            bands_ext=P(None, a, None),
            offsets=self.offsets,
            shape=self.shape,
            axis_name=self.axis_name,
            ext=self.ext,
        )

    def _halo_view(self) -> HaloDIA:
        """HaloDIA on the central band columns (free slice under jit)."""
        E = self.ext
        L = self.bands_ext.shape[-1]
        return HaloDIA(
            bands=self.bands_ext[:, 0, E:L - E],
            offsets=self.offsets,
            shape=self.shape,
            axis_name=self.axis_name,
        )

    def matvec(self, x_local: jax.Array) -> jax.Array:
        return self._halo_view().matvec(x_local)

    def matvec_dot(self, x_local: jax.Array):
        return self._halo_view().matvec_dot(x_local)

    def matmat(self, X_local: jax.Array) -> jax.Array:
        return self._halo_view().matmat(X_local)

    def diagonal(self) -> jax.Array:
        d0 = self.offsets.index(0)
        E = self.ext
        L = self.bands_ext.shape[-1]
        return self.bands_ext[d0, 0, E:L - E]

    def mpk_extend(self, X_local: jax.Array) -> jax.Array:
        """(m + 2·ext, *tail) window: X with ``ext`` neighbor rows each
        side — ONE halo exchange (2 ppermutes) for the whole power chain.
        Unmatched mesh edges read zero (the out-of-range convention)."""
        ax = self.axis_name
        E = self.ext
        m = X_local.shape[0]
        nd = lax.axis_size(ax)
        if E == 0:
            return X_local
        right = lax.ppermute(
            X_local[:E], ax, perm=[(i, (i - 1) % nd) for i in range(1, nd)]
        )
        left = lax.ppermute(
            X_local[m - E:], ax,
            perm=[(i, (i + 1) % nd) for i in range(nd - 1)],
        )
        return jnp.concatenate([left, X_local, right], axis=0)

    def mpk_apply(self, Xe: jax.Array) -> jax.Array:
        """One band product on the extended window — pure local compute.
        Row j of the window is global row (start − ext + j); its result is
        exact wherever the inputs were (window edges shrink by halo per
        application, the caller's accuracy contract)."""
        L = Xe.shape[0]
        Ye = jnp.zeros(
            Xe.shape, dtype=jnp.result_type(self.dtype, Xe.dtype)
        )

        def zrows(r):
            shp = (r,) + Xe.shape[1:]
            return jnp.zeros(shp, Xe.dtype)

        for d, off in enumerate(self.offsets):
            band = self.bands_ext[d, 0]
            if Xe.ndim > 1:
                band = band[:, None]
            if off == 0:
                Ye = Ye + band * Xe
            elif off > 0:
                Ye = Ye + band * jnp.concatenate([Xe[off:], zrows(off)])
            else:
                Ye = Ye + band * jnp.concatenate([zrows(-off), Xe[:off]])
        return Ye

    def mpk_central(self, Xe: jax.Array) -> jax.Array:
        """Slice the central row block back out of a window vector."""
        E = self.ext
        L = Xe.shape[0]
        return Xe[E:L - E]


jax.tree_util.register_dataclass(
    MPKDIA,
    data_fields=("bands_ext",),
    meta_fields=("offsets", "shape", "axis_name", "ext"),
)


def partition_dia_mpk(
    m: DIA, n_devices: int, s: int, axis_name: str = "rows"
) -> MPKDIA:
    """DIA → :class:`MPKDIA` with band windows sized for s-step methods
    (``ext = s · halo``).  Same identity row padding as
    :func:`partition_dia`."""
    base = partition_dia(m, n_devices, axis_name)
    bands = np.asarray(base.bands)
    h = base.halo
    E = int(s) * h
    n_pad = base.shape[0]
    mm = n_pad // n_devices
    if E > mm:
        raise ValueError(
            f"extension {E} = s·halo exceeds rows-per-device {mm}; "
            "reduce s or use fewer devices"
        )
    padded = np.zeros((bands.shape[0], n_pad + 2 * E), dtype=bands.dtype)
    padded[:, E:E + n_pad] = bands
    ext = np.empty((bands.shape[0], n_devices, mm + 2 * E), dtype=bands.dtype)
    for i in range(n_devices):
        ext[:, i, :] = padded[:, i * mm: i * mm + mm + 2 * E]
    return MPKDIA(
        bands_ext=jnp.asarray(ext),
        offsets=base.offsets,
        shape=base.shape,
        axis_name=axis_name,
        ext=E,
    )
