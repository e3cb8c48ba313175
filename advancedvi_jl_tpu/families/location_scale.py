"""Location-scale variational families (mean-field and full-rank).

Redesign of the reference's ``MvLocationScale``
(reference: src/families/location_scale.jl:15-141).  Differences by design:

- The family *is* the parameter pytree.  The reference needs
  ``Optimisers.destructure`` plus a custom mean-field specialization
  (location_scale.jl:28-43) to get a flat parameter vector; here optax and
  jax.grad operate on the pytree directly, so that machinery disappears.
- The mean-field family stores the scale diagonal as a vector natively (the
  reference stores a ``Diagonal`` matrix and special-cases its flattening).
- The full-rank scale is stored as a dense (d, d) array interpreted as its
  lower triangle; every use applies ``jnp.tril`` so the strict upper triangle
  is inert (zero gradient, never read) and shapes stay matmul-friendly.
- ``sample`` is batched: one ``(n, d)`` base draw and a single matmul (one
  GEMM), instead of the reference's per-sample column loop.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..core.pytree import pytree_dataclass, static_field
from .base import Normal


def _solve_lower(C: jax.Array, B: jax.Array, trans: bool) -> jax.Array:
    """Solve tril(C) X = B (or C^T X = B), B of shape (d, n).

    Routes through the native C++ XLA-FFI kernel (ops/cpp/ffi_trisolve.cc,
    measured 3.7x over XLA's solve at the VI d-range) when the backend is
    CPU, dtypes are f32/f64, and no mesh is active; XLA's partitionable
    ``triangular_solve`` otherwise (GPU, sharded, or exotic dtypes).
    """
    from ..ops.native_ffi import trisolve, use_native_trisolve

    if use_native_trisolve(C, B):
        return trisolve(C, B, trans=trans)
    return solve_triangular(C, B, lower=True, trans=1 if trans else 0)


_SOLVE_MODES = ("solve", "inverse")


def _check_solve_mode(q) -> None:
    """Validate solve_mode up-front on every solve path, so a typo'd mode
    can never silently train on the XLA fallback (ADVICE r3)."""
    if q.solve_mode not in _SOLVE_MODES:
        raise ValueError(
            f"solve_mode must be one of {_SOLVE_MODES}, got {q.solve_mode!r}"
        )


@pytree_dataclass
class MeanFieldLocationScale:
    """Family z = diag(scale) * u + location with iid base draws u ~ base.

    Mirrors the reference's ``MvLocationScale{<:Diagonal}``
    (reference: src/families/location_scale.jl:79-87 diag-specialized path).
    """

    location: jax.Array  # (d,)
    scale_diag: jax.Array  # (d,)
    base: Any = static_field(default=Normal())

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        return self.sample_with_base(key, n_samples)[0]

    def sample_with_base(self, key: jax.Array, n_samples: int):
        u = self.base.sample(key, (n_samples, self.dim), self.location.dtype)
        return u * self.scale_diag + self.location, u

    def log_prob(self, z: jax.Array) -> jax.Array:
        u = (z - self.location) / self.scale_diag
        return jnp.sum(self.base.log_prob(u), axis=-1) - jnp.sum(
            jnp.log(jnp.abs(self.scale_diag))
        )

    def entropy(self) -> jax.Array:
        # d * H(base) + log|det scale|  (reference: location_scale.jl:52-57)
        d = self.dim
        return d * jnp.asarray(
            self.base.entropy(), dtype=self.location.dtype
        ) + self.log_det_scale()

    def log_det_scale(self) -> jax.Array:
        return jnp.sum(jnp.log(jnp.abs(self.scale_diag)))

    def apply_inv_scale_T(self, V: jax.Array) -> jax.Array:
        """scale^{-T} applied to each row of (n, d) V (solve-free entropy)."""
        return V / self.scale_diag

    def mean(self) -> jax.Array:
        return self.location + self.scale_diag * self.base.mean()

    def var(self) -> jax.Array:
        return self.base.var() * jnp.square(self.scale_diag)

    def cov(self) -> jax.Array:
        return jnp.diag(self.var())

    def scale_matrix(self) -> jax.Array:
        return jnp.diag(self.scale_diag)


@pytree_dataclass
class FullRankLocationScale:
    """Family z = tril(scale) @ u + location.

    Mirrors the reference's ``MvLocationScale{<:LowerTriangular}``
    (reference: src/families/location_scale.jl:71-77).  ``scale`` is stored
    dense; only its lower triangle is meaningful.
    """

    location: jax.Array  # (d,)
    scale: jax.Array  # (d, d), lower-triangular by convention
    base: Any = static_field(default=Normal())
    # Tensor parallelism for very large d (SURVEY.md §2.7 TP row): mesh axis
    # to shard the scale's ROWS over.  The (n, d) x (d, d) sampling matmul
    # then computes d/n_tp output columns per device; GSPMD keeps the base
    # draw replicated and partitions z column-wise — no collective needed on
    # the forward sampling path (each output column owns its row of C).
    tp_axis: Any = static_field(default=None)
    # Optional reduced precision for the (n, d) x (d, d) sampling matmul
    # ("bfloat16"): operands cast down, f32 accumulation via
    # preferred_element_type (tensor-core mixed precision).  Parameters,
    # solves, and densities stay in the parameter dtype; only the draw's
    # affine map quantizes (~3 decimal digits), which perturbs each z by
    # O(1e-3)·||C|| without biasing the estimator's expectation over u.
    compute_dtype: Any = static_field(default=None)
    # How to apply C^{-1} / C^{-T} on the hot paths (log_prob whitening, STL
    # entropy backward).  "solve": XLA triangular_solve (cuBLAS trsm on a
    # GPU) — blocked substitution, best worst-case rounding.  "inverse":
    # level-parallel blocked triangular inverse (ops/trinv.py) computed per
    # call, then a plain matmul — O(log d) sequential depth instead of
    # O(d/block).  Both are timed on the card in PERF.md.
    solve_mode: str = static_field(default="solve")
    # Memory layout of ``scale``.  "dense": (d, d) array, lower triangle
    # meaningful (the default; required by tp_axis row sharding and the
    # measure-space algorithms, which rebuild dense factors each step).
    # "packed": the lower triangle in blocked packed form (ops/packing.py)
    # — halves the memory traffic of every elementwise pass over the
    # parameters (optimizer, operators, averaging); the dense factor is
    # materialized only for the sampling matmul and the solves.
    layout: str = static_field(default="dense")

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    def tril_scale(self) -> jax.Array:
        if self.layout == "packed":
            if self.tp_axis is not None:
                raise ValueError(
                    "layout='packed' cannot row-shard the scale; use "
                    "layout='dense' with tp_axis"
                )
            from ..ops.packing import tril_unpack

            return tril_unpack(self.scale, self.dim)
        if self.layout != "dense":
            raise ValueError(
                f"layout must be 'dense' or 'packed', got {self.layout!r}"
            )
        from ..parallel.mesh import shard_axis0

        # shard_axis0 no-ops outside a mesh, so a tp-configured family still
        # evaluates on a single device (e.g. post-training diagnostics).
        return shard_axis0(jnp.tril(self.scale), self.tp_axis)

    def scale_diag_view(self) -> jax.Array:
        """Diagonal of the effective scale, layout-agnostic."""
        if self.layout == "packed":
            from ..ops.packing import packed_diag

            return packed_diag(self.scale, self.dim)
        return jnp.diag(self.scale)

    def with_scale_diag(self, new_diag: jax.Array) -> "FullRankLocationScale":
        """Family with the scale diagonal replaced EXACTLY by ``new_diag``
        (zero-then-set, no catastrophic cancellation), off-diagonal kept
        as stored.  Layout-agnostic — the operator layer's entry point."""
        if self.layout == "packed":
            from ..ops.packing import packed_with_diag

            return self.replace(
                scale=packed_with_diag(self.scale, self.dim, new_diag)
            )
        C = self.scale
        d0 = jnp.diag(C)
        return self.replace(scale=C - jnp.diag(d0) + jnp.diag(new_diag))

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        return self.sample_with_base(key, n_samples)[0]

    def sample_with_base(self, key: jax.Array, n_samples: int):
        u = self.base.sample(key, (n_samples, self.dim), self.location.dtype)
        C = self.tril_scale()
        # (n, d) @ (d, d)^T : one matmul for the whole batch.
        if self.compute_dtype is not None:
            cd = jnp.dtype(self.compute_dtype)
            z = (
                jnp.matmul(
                    u.astype(cd),
                    C.T.astype(cd),
                    preferred_element_type=self.location.dtype,
                )
                + self.location
            )
        else:
            z = u @ C.T + self.location
        return z, u

    def log_prob(self, z: jax.Array) -> jax.Array:
        _check_solve_mode(self)
        C = self.tril_scale()
        # Batched triangular solve: the STL hot path `scale \ (z - location)`
        # (reference: location_scale.jl:59-63), batched over samples.
        diff = z - self.location
        if self.solve_mode == "inverse":
            T = self._tril_inverse(C)
            u = diff @ T.T
        elif diff.ndim == 1:
            u = _solve_lower(C, diff[:, None], trans=False)[:, 0]
        else:
            u = _solve_lower(C, diff.T, trans=False).T
        return (
            jnp.sum(self.base.log_prob(u), axis=-1) - self.log_det_scale()
        )

    def entropy(self) -> jax.Array:
        d = self.dim
        return d * jnp.asarray(
            self.base.entropy(), dtype=self.location.dtype
        ) + self.log_det_scale()

    def log_det_scale(self) -> jax.Array:
        return jnp.sum(jnp.log(jnp.abs(self.scale_diag_view())))

    def apply_inv_scale_T(self, V: jax.Array) -> jax.Array:
        """C^{-T} applied to each row of (n, d) V: one transposed triangular
        solve (the only solve left on the fast STL path) — or, with
        solve_mode="inverse", one blocked inverse + one matmul."""
        _check_solve_mode(self)
        C = self.tril_scale()
        if self.solve_mode == "inverse":
            return V @ self._tril_inverse(C)
        return _solve_lower(C, V.T, trans=True).T

    def _tril_inverse(self, C: jax.Array) -> jax.Array:
        from ..ops.trinv import tril_inverse

        return tril_inverse(C)

    def mean(self) -> jax.Array:
        mu_b = self.base.mean()
        if mu_b == 0.0:
            return self.location
        return self.location + self.tril_scale() @ jnp.full(
            (self.dim,), mu_b, dtype=self.location.dtype
        )

    def var(self) -> jax.Array:
        C = self.tril_scale()
        return self.base.var() * jnp.sum(C * C, axis=1)

    def cov(self) -> jax.Array:
        C = self.tril_scale()
        return self.base.var() * (C @ C.T)

    def scale_matrix(self) -> jax.Array:
        return self.tril_scale()


def MeanFieldGaussian(
    location: jax.Array,
    scale_diag: jax.Array | None = None,
) -> MeanFieldLocationScale:
    """Gaussian with diagonal covariance (reference: location_scale.jl:124-141)."""
    location = jnp.asarray(location)
    if scale_diag is None:
        scale_diag = jnp.ones_like(location)
    return MeanFieldLocationScale(
        location=location,
        scale_diag=jnp.asarray(scale_diag),
        base=Normal(),
    )


def FullRankGaussian(
    location: jax.Array,
    scale: jax.Array | None = None,
    compute_dtype: Any = None,
    solve_mode: str = "solve",
    layout: str = "dense",
) -> FullRankLocationScale:
    """Gaussian with dense (Cholesky-factor) covariance.

    ``layout="packed"`` stores the scale as its (d(d+1)/2,) lower triangle —
    the bandwidth-halving layout for large d (see FullRankLocationScale).
    ``scale`` is always passed dense here; it is packed at construction.
    """
    location = jnp.asarray(location)
    if scale is None:
        scale = jnp.eye(location.shape[-1], dtype=location.dtype)
    # Normalize to lower-triangular at construction so the stored parameters
    # equal the effective ones (keeps optimizer distance metrics honest).
    scale = jnp.tril(jnp.asarray(scale))
    if layout == "packed":
        from ..ops.packing import tril_pack

        scale = tril_pack(scale)
    return FullRankLocationScale(
        location=location,
        scale=scale,
        base=Normal(),
        compute_dtype=compute_dtype,
        solve_mode=solve_mode,
        layout=layout,
    )


def is_location_scale(q: Any) -> bool:
    from .low_rank import LowRankLocationScale

    return isinstance(
        q, (MeanFieldLocationScale, FullRankLocationScale, LowRankLocationScale)
    )
