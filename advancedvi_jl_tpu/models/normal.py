"""Analytic Gaussian test targets with ground truth.

Analogues of the reference test fixtures ``TestNormal`` /
``normal_fullrank`` / ``normal_meanfield`` (reference: test/models/normal.jl:2-75):
a d-dimensional Gaussian whose true posterior mean/scale are known, presented
at a chosen capability order so the gradient/Hessian estimator paths can be
exercised independently.
"""

from __future__ import annotations

import math
import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..core.problem import ORDER_JAX
from ..core.pytree import pytree_dataclass


@pytree_dataclass
class NormalTarget:
    """N(mu, L L^T) log-density with analytic ground truth.

    ``inv_scale_tril``: optional precomputed L^{-1}.  L is a CONSTANT of the
    target, so the per-evaluation triangular solve can be traded for one
    matmul — for hot loops a (n, d) x (d, d) matmul runs at the GEMM rate,
    where a batched substitution is a chain of dependent steps.  Built by
    :meth:`solve_free`; both forms are the same density to f32 round-off.
    """

    mu: jax.Array  # (d,)
    scale_tril: jax.Array  # (d, d) lower-triangular Cholesky factor
    inv_scale_tril: jax.Array | None = None  # optional precomputed L^{-1}

    @property
    def dim(self) -> int:
        return self.mu.shape[-1]

    def order(self) -> int:
        return ORDER_JAX

    def solve_free(self) -> "NormalTarget":
        """Precompute L^{-1} once so every log_density is matmul-only."""
        T = solve_triangular(
            self.scale_tril,
            jnp.eye(self.dim, dtype=self.scale_tril.dtype),
            lower=True,
        )
        return NormalTarget(
            mu=self.mu, scale_tril=self.scale_tril, inv_scale_tril=T
        )

    def log_density(self, theta: jax.Array) -> jax.Array:
        L = self.scale_tril
        if self.inv_scale_tril is not None:
            u = (theta - self.mu) @ self.inv_scale_tril.T
        else:
            u = solve_triangular(L, theta - self.mu, lower=True)
        d = self.dim
        return (
            -0.5 * jnp.dot(u, u)
            - jnp.sum(jnp.log(jnp.abs(jnp.diag(L))))
            - 0.5 * d * math.log(2.0 * math.pi)
        )


def normal_fullrank(key: jax.Array, n_dims: int = 5, dtype=jnp.float32):
    """Correlated Gaussian target (reference: test/models/normal.jl fullrank).

    Returns (target, mu_true, scale_tril_true).
    """
    k1, k2 = jax.random.split(key)
    mu = jax.random.normal(k1, (n_dims,), dtype)
    # Well-conditioned random lower-triangular factor.
    A = 0.3 * jax.random.normal(k2, (n_dims, n_dims), dtype)
    L = jnp.tril(A, -1) + jnp.diag(1.0 + 0.5 * jnp.abs(jnp.diag(A)))
    return NormalTarget(mu=mu, scale_tril=L), mu, L


def normal_fullrank_wellcond(
    key: jax.Array, n_dims: int, dtype=jnp.float32
):
    """Correlated Gaussian target that stays well-conditioned at LARGE d.

    ``normal_fullrank``'s construction (O(1) off-diagonal entries) is the
    reference fixture's shape, but random triangular factors with O(1)
    entries have exponentially growing ``||L^{-1}||`` in d — fine at the
    test d-range, numerically pathological past d ~ few hundred (f32 ELBOs
    reach -1e32 and overflow at d=2048).  This variant scales the
    off-diagonal by 1/sqrt(d) (unit-norm rows in expectation), keeping the
    condition number modest at any d — the right fixture for large-model
    benchmarks.
    """
    k1, k2 = jax.random.split(key)
    mu = jax.random.normal(k1, (n_dims,), dtype)
    A = jax.random.normal(k2, (n_dims, n_dims), dtype) * (
        0.3 / n_dims**0.5
    )
    L = jnp.tril(A, -1) + jnp.eye(n_dims, dtype=dtype)
    return NormalTarget(mu=mu, scale_tril=L), mu, L


def normal_meanfield(key: jax.Array, n_dims: int = 5, dtype=jnp.float32):
    """Diagonal Gaussian target (reference: test/models/normal.jl meanfield)."""
    k1, k2 = jax.random.split(key)
    mu = jax.random.normal(k1, (n_dims,), dtype)
    sigma = 0.5 + jax.random.uniform(k2, (n_dims,), dtype)
    L = jnp.diag(sigma)
    return NormalTarget(mu=mu, scale_tril=L), mu, L
