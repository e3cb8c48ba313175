"""Bayesian neural-network posterior (BASELINE config #5).

A small MLP regression posterior: weights ~ N(0, 1), y ~ N(f_w(x), sigma^2).
theta is the flattened weight vector; the forward pass is two matmuls
batched over the whole dataset, so a mean-field ADVI step over this target is
matmul-dominated — the workload where sample-sharding pays off.
Supports minibatch subsampling with likelihood rescaling.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.problem import ORDER_JAX
from ..core.pytree import pytree_dataclass, static_field


@pytree_dataclass
class BayesianMLP:
    X: jax.Array  # (n, in_dim)
    y: jax.Array  # (n,)
    likeadj: jax.Array  # scalar
    hidden: int = static_field(default=32)
    noise_scale: float = static_field(default=0.1)
    data_axis: Optional[str] = static_field(default=None)
    # Optional reduced matmul precision ("bfloat16"): inputs cast down,
    # accumulation stays float32 (preferred_element_type). The posterior
    # parameters, prior, and likelihood reduction remain float32 — only the
    # forward-pass contractions run at bf16, the tensor cores' fastest
    # input format. Opt in when the likelihood is matmul-dominated and
    # ~3-digit predictions are acceptable.
    compute_dtype: Optional[str] = static_field(default=None)

    @property
    def in_dim(self) -> int:
        return self.X.shape[1]

    @property
    def dim(self) -> int:
        h, i = self.hidden, self.in_dim
        return i * h + h + h + 1  # W1, b1, W2, b2

    def order(self) -> int:
        return ORDER_JAX

    def _unpack(self, theta: jax.Array):
        h, i = self.hidden, self.in_dim
        ofs = 0
        W1 = theta[ofs : ofs + i * h].reshape(i, h)
        ofs += i * h
        b1 = theta[ofs : ofs + h]
        ofs += h
        W2 = theta[ofs : ofs + h]
        ofs += h
        b2 = theta[ofs]
        return W1, b1, W2, b2

    def forward(self, theta: jax.Array, X: jax.Array) -> jax.Array:
        W1, b1, W2, b2 = self._unpack(theta)
        if self.compute_dtype is not None:
            cd = jnp.dtype(self.compute_dtype)
            h = jnp.dot(
                X.astype(cd), W1.astype(cd),
                preferred_element_type=jnp.float32,
            )
            hcore = jnp.tanh(h + b1)  # (n, h), float32
            return (
                jnp.dot(
                    hcore.astype(cd), W2.astype(cd),
                    preferred_element_type=jnp.float32,
                )
                + b2
            )
        hcore = jnp.tanh(X @ W1 + b1)  # (n, h) — one matmul
        return hcore @ W2 + b2  # (n,)

    def log_density(self, theta: jax.Array) -> jax.Array:
        pred = self.forward(theta, self.X)
        if self.data_axis is not None:
            from jax.sharding import PartitionSpec as P

            pred = jax.lax.with_sharding_constraint(pred, P(self.data_axis))
        s = self.noise_scale
        loglike = jnp.sum(
            -0.5 * jnp.square((self.y - pred) / s)
            - math.log(s)
            - 0.5 * math.log(2.0 * math.pi)
        )
        logprior = jnp.sum(
            -0.5 * jnp.square(theta) - 0.5 * math.log(2.0 * math.pi)
        )
        return self.likeadj * loglike + logprior

    def subsample(self, indices: jax.Array) -> "BayesianMLP":
        n = self.X.shape[0]
        return self.replace(
            X=jnp.take(self.X, indices, axis=0),
            y=jnp.take(self.y, indices, axis=0),
            likeadj=self.likeadj * (n / indices.shape[0]),
        )


def make_bnn(
    key: jax.Array,
    n_data: int = 256,
    in_dim: int = 8,
    hidden: int = 32,
    dtype=jnp.float32,
) -> BayesianMLP:
    k1, k2, k3 = jax.random.split(key, 3)
    X = jax.random.normal(k1, (n_data, in_dim), dtype)
    f = jnp.sin(X @ jax.random.normal(k2, (in_dim,), dtype))
    y = f + 0.1 * jax.random.normal(k3, (n_data,), dtype)
    return BayesianMLP(
        X=X, y=y, likeadj=jnp.ones((), dtype), hidden=hidden
    )
