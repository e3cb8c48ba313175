"""Block-diagonal full-rank Gaussian family.

The natural middle point between the reference's two Gaussian families
(mean-field `Diagonal` and full-rank `LowerTriangular` scales,
reference: src/families/location_scale.jl:15-141): B independent blocks of
size k, each with its own dense Cholesky factor.  Hierarchical posteriors
(per-group parameters that correlate within a group but not across groups)
get full within-block covariance at O(B k^2) parameters instead of
O((Bk)^2).

Shape: all block ops are BATCHED small-matrix ops — sampling is
one `(B, k, k) x (n, B, k)` einsum, `log_prob` a vmapped triangular
solve — exactly the layout XLA tiles well.  The block axis is also a mesh
axis candidate (`block_axis=`): blocks shard like experts, with no
cross-block communication on the sampling path.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..core.pytree import pytree_dataclass, static_field
from .base import Normal


@pytree_dataclass
class BlockDiagLocationScale:
    """q = N(location, blockdiag(C_1 C_1^T, ..., C_B C_B^T)).

    ``location`` is flat (B*k,) — the family plugs into every objective and
    target unchanged; block b owns coordinates [b*k, (b+1)*k).  ``scales``
    stores dense (B, k, k) blocks interpreted as their lower triangles
    (strict upper entries inert, like FullRankLocationScale).
    """

    location: jax.Array  # (B*k,)
    scales: jax.Array  # (B, k, k), lower-triangular by convention
    base: Any = static_field(default=Normal())
    block_axis: Optional[str] = static_field(default=None)

    @property
    def n_blocks(self) -> int:
        return self.scales.shape[0]

    @property
    def block_dim(self) -> int:
        return self.scales.shape[-1]

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    def tril_scales(self) -> jax.Array:
        from ..parallel.mesh import shard_axis0

        return shard_axis0(jnp.tril(self.scales), self.block_axis)

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        return self.sample_with_base(key, n_samples)[0]

    def sample_with_base(self, key: jax.Array, n_samples: int):
        B, k = self.n_blocks, self.block_dim
        u = self.base.sample(key, (n_samples, B, k), self.location.dtype)
        C = self.tril_scales()
        # (B, k, k) x (n, B, k) -> (n, B, k): one batched matmul.
        z = jnp.einsum("bij,nbj->nbi", C, u)
        return (
            z.reshape(n_samples, B * k) + self.location,
            u.reshape(n_samples, B * k),
        )

    def log_prob(self, z: jax.Array) -> jax.Array:
        B, k = self.n_blocks, self.block_dim
        squeeze = z.ndim == 1
        if squeeze:
            z = z[None, :]
        C = self.tril_scales()
        diff = (z - self.location).reshape(z.shape[0], B, k)

        def solve_block(Cb, db):  # db: (n, k)
            return solve_triangular(Cb, db.T, lower=True).T

        u = jax.vmap(solve_block, in_axes=(0, 1), out_axes=1)(C, diff)
        logdet = jnp.sum(
            jnp.log(jnp.abs(jnp.diagonal(C, axis1=-2, axis2=-1)))
        )
        out = jnp.sum(self.base.log_prob(u), axis=(-2, -1)) - logdet
        return out[0] if squeeze else out

    def entropy(self) -> jax.Array:
        d = self.dim
        logdet = jnp.sum(
            jnp.log(jnp.abs(jnp.diagonal(self.scales, axis1=-2, axis2=-1)))
        )
        return d * jnp.asarray(
            self.base.entropy(), dtype=self.location.dtype
        ) + logdet

    def mean(self) -> jax.Array:
        return self.location  # symmetric zero-mean bases

    def var(self) -> jax.Array:
        C = self.tril_scales()
        return self.base.var() * jnp.sum(C * C, axis=-1).reshape(-1)

    def cov(self) -> jax.Array:
        """Dense (B*k, B*k) block-diagonal covariance (diagnostics only)."""
        C = self.tril_scales()
        blocks = self.base.var() * jnp.einsum("bij,bkj->bik", C, C)
        return jax.scipy.linalg.block_diag(*blocks)

    def scale_matrix(self) -> jax.Array:
        return jax.scipy.linalg.block_diag(*self.tril_scales())


def BlockDiagGaussian(
    location: jax.Array,
    scales: jax.Array | None = None,
    n_blocks: int | None = None,
) -> BlockDiagLocationScale:
    """Gaussian with block-diagonal covariance.

    Either pass explicit ``scales`` of shape (B, k, k), or ``n_blocks`` to
    start from identity blocks (location length must divide evenly).
    """
    location = jnp.asarray(location)
    if scales is None:
        if n_blocks is None:
            raise ValueError("pass scales=(B, k, k) or n_blocks=")
        d = location.shape[-1]
        if d % n_blocks:
            raise ValueError(
                f"dim {d} is not divisible into {n_blocks} equal blocks"
            )
        k = d // n_blocks
        scales = jnp.broadcast_to(
            jnp.eye(k, dtype=location.dtype), (n_blocks, k, k)
        )
    scales = jnp.tril(jnp.asarray(scales))
    if scales.shape[0] * scales.shape[-1] != location.shape[-1]:
        raise ValueError(
            f"scales {scales.shape} cover dim "
            f"{scales.shape[0] * scales.shape[-1]} != location dim "
            f"{location.shape[-1]}"
        )
    return BlockDiagLocationScale(location=location, scales=scales)
