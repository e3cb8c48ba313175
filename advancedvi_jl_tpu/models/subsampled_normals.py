"""Subsampled-normals test target with analytic posterior.

Analogue of the reference fixture ``SubsampledNormals``
(reference: test/models/subsamplednormals.jl): a 1-dim product of n unit-scale
Normal factors N(mu_i, 1) in x — an unnormalized "posterior" whose normalized
density is N(mean(mu), 1/n).  ``subsample`` keeps a minibatch of factors and
rescales by n/batch, so epoch-averaged minibatch gradients match the
full-batch gradient in expectation.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..core.problem import ORDER_JAX
from ..core.pytree import pytree_dataclass


@pytree_dataclass
class SubsampledNormals:
    mus: jax.Array  # (n,)
    likeadj: jax.Array  # scalar

    @property
    def dim(self) -> int:
        return 1

    def order(self) -> int:
        return ORDER_JAX

    def log_density(self, x: jax.Array) -> jax.Array:
        x0 = x[0]
        lps = -0.5 * jnp.square(x0 - self.mus) - 0.5 * math.log(2.0 * math.pi)
        return self.likeadj * jnp.sum(lps)

    def subsample(self, indices: jax.Array) -> "SubsampledNormals":
        n = self.mus.shape[0]
        return SubsampledNormals(
            mus=jnp.take(self.mus, indices),
            likeadj=self.likeadj * (n / indices.shape[0]),
        )


def subsampled_normals(key: jax.Array, n_data: int, dtype=jnp.float32):
    """Returns (target, mu_true (1,), scale_true (1, 1))."""
    mus = jax.random.normal(key, (n_data,), dtype)
    target = SubsampledNormals(mus=mus, likeadj=jnp.ones((), dtype))
    mu_true = jnp.mean(mus)[None]
    L_true = jnp.asarray([[1.0 / math.sqrt(n_data)]], dtype)
    return target, mu_true, L_true
