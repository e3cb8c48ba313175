"""Factorized targets: the PPL-bridge analogue with subsampling for free.

Redesign of the reference's DynamicPPL extension
(reference: ext/AdvancedVIDynamicPPLExt.jl:1-211).  The extension's job is to
expose a PPL model as a weighted log-joint

    likeadj * loglikelihood + logprior - logjacobian

with a mutable ``likeadj`` Ref so ``subsample`` can rescale the likelihood in
place without re-preparing AD.  Here the same contract is a pytree dataclass:
users supply

- ``logprior_fn(theta)``                       — jax-traceable
- ``loglike_fn(theta, data_batch)``            — per-BATCH log-likelihood,
  jax-traceable, must be a sum over the batch rows

and get the full target protocol — including static-shape minibatch
``subsample`` with automatic n/batch likelihood rescaling, and bijector
support via ``.unconstrained(transform)`` — with no per-model boilerplate.
``jit`` re-tracing on the minibatch shape replaces the reference's
"prepare AD on the subsampled problem type" dance (subsampledobjective.jl:22-45).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from .problem import ORDER_JAX
from .pytree import pytree_dataclass, static_field
from .transforms import Transform, TransformedTarget


@pytree_dataclass
class FactorizedTarget:
    """logprior(theta) + likeadj * loglike(theta, data)."""

    data: Any  # pytree whose leaves have the batch dimension first
    likeadj: jax.Array  # scalar likelihood rescaling
    logprior_fn: Callable = static_field()
    loglike_fn: Callable = static_field()
    dim: int = static_field()
    n_data: int = static_field()
    data_axis: Optional[str] = static_field(default=None)

    def order(self) -> int:
        return ORDER_JAX

    def log_density(self, theta: jax.Array) -> jax.Array:
        from ..parallel.mesh import shard_axis0

        data = jax.tree.map(
            lambda x: shard_axis0(x, self.data_axis), self.data
        )
        return self.logprior_fn(theta) + self.likeadj * self.loglike_fn(
            theta, data
        )

    def subsample(self, indices: jax.Array) -> "FactorizedTarget":
        batch = indices.shape[0]
        return FactorizedTarget(
            data=jax.tree.map(
                lambda x: jnp.take(x, indices, axis=0), self.data
            ),
            likeadj=self.likeadj * (self.n_data / batch),
            logprior_fn=self.logprior_fn,
            loglike_fn=self.loglike_fn,
            dim=self.dim,
            n_data=self.n_data,
            data_axis=self.data_axis,
        )

    def unconstrained(self, transform: Transform) -> TransformedTarget:
        return TransformedTarget(prob=self, transform=transform)


def factorized_target(
    logprior_fn: Callable,
    loglike_fn: Callable,
    data: Any,
    dim: int,
    data_axis: Optional[str] = None,
) -> FactorizedTarget:
    n_data = jax.tree.leaves(data)[0].shape[0]
    dtype = jax.tree.leaves(data)[0].dtype
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.float32
    return FactorizedTarget(
        data=data,
        likeadj=jnp.ones((), dtype),
        logprior_fn=logprior_fn,
        loglike_fn=loglike_fn,
        dim=dim,
        n_data=n_data,
        data_axis=data_axis,
    )
