"""Diagonal-plus-low-rank location-scale family.

Redesign of ``MvLocationScaleLowRank``
(reference: src/families/location_scale_low_rank.jl:18-136): covariance
``sigma^2_base * (D^2 + U U^T)`` with ``D = diag(scale_diag)`` (d,) and factors
``U`` (d, r).  Sampling is ``z = D u1 + U u2 + m`` with one (n, r) x (r, d)
matmul for the factor term.

``log_prob``/``entropy`` pick between two differentiable paths by STATIC
dimension (jit-safe), replacing the reference's differentiable-vs-fast split
(``non_differntiable`` kwarg, :45-68) with a conditioning-driven one:

- dense (d <= _DENSE_LOGPROB_MAX_DIM): cholesky of Sigma = D^2 + U U^T.
  O(d^3), but stable whenever Sigma itself is well-conditioned — in
  particular when the optimizer drives an entry of D to the ClipScale floor
  while U covers that direction (Sigma fine, D^-2 = 1e10: the Woodbury form
  suffers catastrophic float32 cancellation there and returns -inf/garbage).
- Woodbury (larger d): O(d r^2 + r^3) per batch via the matrix determinant
  lemma; requires D bounded away from 0 relative to float precision.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from ..core.pytree import pytree_dataclass, static_field
from .base import Normal

# Dense-cholesky log_prob/entropy below this dimension (stability); Woodbury
# above it (speed): one (d, d) cholesky per step is cheap next to the
# sampling work for the d-range where VI families are full pytrees.
_DENSE_LOGPROB_MAX_DIM = 512


@pytree_dataclass
class LowRankLocationScale:
    location: jax.Array  # (d,)
    scale_diag: jax.Array  # (d,)
    scale_factors: jax.Array  # (d, r)
    base: Any = static_field(default=Normal())

    @property
    def dim(self) -> int:
        return self.location.shape[-1]

    @property
    def rank(self) -> int:
        return self.scale_factors.shape[-1]

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        k1, k2 = jax.random.split(key)
        dtype = self.location.dtype
        u_diag = self.base.sample(k1, (n_samples, self.dim), dtype)
        u_fact = self.base.sample(k2, (n_samples, self.rank), dtype)
        return (
            u_diag * self.scale_diag
            + u_fact @ self.scale_factors.T
            + self.location
        )

    def _chol_sigma(self) -> jax.Array:
        """Cholesky of Sigma = D^2 + U U^T (dense path)."""
        sigma = jnp.diag(jnp.square(self.scale_diag)) + (
            self.scale_factors @ self.scale_factors.T
        )
        return jnp.linalg.cholesky(sigma)

    def _logdet_sigma(self) -> jax.Array:
        if self.dim <= _DENSE_LOGPROB_MAX_DIM:
            return 2.0 * jnp.sum(jnp.log(jnp.diagonal(self._chol_sigma())))
        # Matrix determinant lemma:
        #   logdet(D^2 + U U^T) = 2 sum log D + logdet(I + U^T D^-2 U)
        # (reference: location_scale_low_rank.jl:35-43)
        D2 = jnp.square(self.scale_diag)
        UtDinvU = self.scale_factors.T @ (self.scale_factors / D2[:, None])
        inner = jnp.eye(self.rank, dtype=D2.dtype) + UtDinvU
        _, logdet_inner = jnp.linalg.slogdet(inner)
        return 2.0 * jnp.sum(jnp.log(jnp.abs(self.scale_diag))) + logdet_inner

    def entropy(self) -> jax.Array:
        d = self.dim
        dtype = self.location.dtype
        return d * jnp.asarray(
            self.base.entropy(), dtype=dtype
        ) + 0.5 * self._logdet_sigma()

    def log_prob(self, z: jax.Array) -> jax.Array:
        """Gaussian-base log-density; dense-cholesky or Woodbury path by
        static dimension (see module docstring).

        Exact for the Gaussian base (the reference's non-Gaussian low-rank
        logpdf path is only valid for Gaussian bases anyway, since D u1 + U u2
        equals L u in distribution only under rotation invariance).
        """
        single = z.ndim == 1
        zb = z[None, :] if single else z  # (n, d)
        d = self.dim
        diff = zb - self.mean()  # (n, d)
        dtype = self.location.dtype
        if d <= _DENSE_LOGPROB_MAX_DIM:
            L = self._chol_sigma()
            v = jax.lax.linalg.triangular_solve(
                L, diff.T, left_side=True, lower=True
            )  # (d, n)
            quad = jnp.sum(jnp.square(v), axis=0)
            logdet_sigma = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
        else:
            D2 = jnp.square(self.scale_diag)
            U = self.scale_factors
            # Sigma^-1 = D^-2 - D^-2 U (I + U^T D^-2 U)^-1 U^T D^-2
            dinv2_diff = diff / D2  # (n, d)
            w = dinv2_diff @ U  # (n, r)
            inner = jnp.eye(self.rank, dtype=D2.dtype) + U.T @ (
                U / D2[:, None]
            )
            sol = cho_solve(cho_factor(inner), w.T).T  # (n, r)
            quad = jnp.sum(diff * dinv2_diff, axis=-1) - jnp.sum(
                w * sol, axis=-1
            )
            logdet_sigma = self._logdet_sigma()
        out = -0.5 * (
            quad
            + logdet_sigma
            + d * jnp.asarray(jnp.log(2.0 * jnp.pi), dtype=dtype)
        )
        return out[0] if single else out

    def mean(self) -> jax.Array:
        mu_b = self.base.mean()
        if mu_b == 0.0:
            return self.location
        return (
            self.location
            + self.scale_diag * mu_b
            + self.scale_factors @ jnp.full(
                (self.rank,), mu_b, dtype=self.location.dtype
            )
        )

    def var(self) -> jax.Array:
        return self.base.var() * (
            jnp.square(self.scale_diag)
            + jnp.sum(jnp.square(self.scale_factors), axis=1)
        )

    def cov(self) -> jax.Array:
        return self.base.var() * (
            jnp.diag(jnp.square(self.scale_diag))
            + self.scale_factors @ self.scale_factors.T
        )


def LowRankGaussian(
    location: jax.Array, scale_diag: jax.Array, scale_factors: jax.Array
) -> LowRankLocationScale:
    """Gaussian with D + U U^T scale (reference: location_scale_low_rank.jl:124-136)."""
    return LowRankLocationScale(
        location=jnp.asarray(location),
        scale_diag=jnp.asarray(scale_diag),
        scale_factors=jnp.asarray(scale_factors),
        base=Normal(),
    )
