"""Hierarchical Bayesian logistic regression (the flagship benchmark model).

The reference's README example (reference: README.md:27-140):

    sigma ~ LogNormal(0, 3)
    beta  ~ Normal(0_d, sigma^2 I_d)
    y     ~ BernoulliLogit(X beta)

theta = [beta (d), sigma (1)]; sigma > 0 so the unconstrained-space target is
``LogReg(...).unconstrained()`` = TransformedTarget with a Stacked(Identity_d,
Exp_1) bijector, exactly the reference's Bijectors.Stacked pattern.

Design: the likelihood is one (n, d) x (d,) matvec plus fused
elementwise log-sigmoid terms; subsampling gathers minibatch rows with a
static shape and rescales the likelihood by n/batch (the reference's
``subsample`` contract, src/AdvancedVI.jl:303-319).  Under a device mesh the
minibatch rows can be sharded over the "data" axis.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.problem import ORDER_JAX
from ..core.pytree import pytree_dataclass, static_field
from ..core.transforms import Exp, Identity, TransformedTarget, stacked


@pytree_dataclass
class LogReg:
    """Constrained-space target: theta = [beta, sigma], sigma > 0."""

    X: jax.Array  # (n, d)
    y: jax.Array  # (n,) in {0, 1}
    likeadj: jax.Array  # likelihood rescaling for minibatching (scalar)
    prior_scale: float = static_field(default=3.0)
    data_axis: Optional[str] = static_field(default=None)

    @property
    def dim(self) -> int:
        return self.X.shape[1] + 1

    def order(self) -> int:
        return ORDER_JAX

    def log_density(self, theta: jax.Array) -> jax.Array:
        d = self.X.shape[1]
        beta, sigma = theta[:d], theta[d]

        # log p(beta | sigma) = sum_i N(beta_i; 0, sigma^2)
        logprior_beta = (
            -0.5 * jnp.sum(jnp.square(beta)) / jnp.square(sigma)
            - d * jnp.log(sigma)
            - 0.5 * d * math.log(2.0 * math.pi)
        )
        # log p(sigma) = LogNormal(0, prior_scale)
        s = self.prior_scale
        logsig = jnp.log(sigma)
        logprior_sigma = (
            -jnp.square(logsig) / (2.0 * s * s)
            - logsig
            - math.log(s)
            - 0.5 * math.log(2.0 * math.pi)
        )

        logits = self.X @ beta  # one matvec over the whole (mini)batch
        from ..parallel.mesh import shard_axis0

        logits = shard_axis0(logits, self.data_axis)
        # Bernoulli-logit: y * l - softplus(l), one elementwise fusion.
        loglike = jnp.sum(self.y * logits - jax.nn.softplus(logits))
        return self.likeadj * loglike + logprior_beta + logprior_sigma

    def subsample(self, indices: jax.Array) -> "LogReg":
        """Static-shape minibatch restriction with n/batch rescaling."""
        n = self.X.shape[0]
        batch = indices.shape[0]
        return LogReg(
            X=jnp.take(self.X, indices, axis=0),
            y=jnp.take(self.y, indices, axis=0),
            likeadj=self.likeadj * (n / batch),
            prior_scale=self.prior_scale,
            data_axis=self.data_axis,
        )

    def unconstrained(self) -> TransformedTarget:
        """Unconstrained-space target (identity on beta, exp on sigma)."""
        d = self.X.shape[1]
        return TransformedTarget(
            prob=self, transform=stacked((Identity(), d), (Exp(), 1))
        )


def make_logreg(
    key: jax.Array,
    n_data: int = 208,
    n_features: int = 60,
    dtype=jnp.float32,
    data_axis: Optional[str] = None,
) -> LogReg:
    """Synthetic sonar-like dataset (208 x 60 + intercept, standardized),
    matching the shape of the reference's UCI sonar benchmark (README.md:141-160).
    """
    k1, k2, k3 = jax.random.split(key, 3)
    X = jax.random.normal(k1, (n_data, n_features), dtype)
    X = (X - X.mean(axis=0)) / X.std(axis=0)
    X = jnp.concatenate([X, jnp.ones((n_data, 1), dtype)], axis=1)
    beta_true = jax.random.normal(k2, (n_features + 1,), dtype)
    logits = X @ beta_true
    y = (
        jax.random.uniform(k3, (n_data,), dtype) < jax.nn.sigmoid(logits)
    ).astype(dtype)
    return LogReg(
        X=X, y=y, likeadj=jnp.ones((), dtype), data_axis=data_axis
    )
