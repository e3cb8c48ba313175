"""Score-function (REINFORCE) ELBO gradient via the VarGrad objective.

Redesign of ``ScoreGradELBO``
(reference: src/algorithms/scoregradelbo.jl:15-117).  VarGrad / leave-one-out
control variate (Richter et al. 2020): draw samples with stopped gradients,
evaluate the target log-density with stopped gradients, then differentiate

    var_n(f) / 2,   f_i = log q(z_i) - log pi(z_i)

w.r.t. the variational parameters.  Only ``log q`` is differentiated, so the
target need NOT be differentiable — this is the objective for value-only
(order-0) targets, e.g. external simulators wrapped in callbacks.

The reported ``elbo`` info is the plain ELBO estimate, not the VarGrad value
(the reference makes the same distinction: scoregradelbo.jl:96-117).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field, tree_stop_gradient
from ..parallel.mesh import shard_axis0


@pytree_dataclass
class ScoreGradELBO:
    n_samples: int = static_field(default=2)
    mc_axis: Optional[str] = static_field(default=None)

    def __post_init__(self):
        # The VarGrad loss is the sample variance of f = log q - log pi:
        # with a single sample it is identically zero and every gradient
        # vanishes — training would be a silent no-op (the reference inherits
        # this trap from its n_samples=1 default; we reject it instead).
        if self.n_samples < 2:
            raise ValueError(
                "ScoreGradELBO (VarGrad) needs n_samples >= 2: the "
                "leave-one-out control variate is a sample variance, which "
                f"is identically 0 for n_samples={self.n_samples}."
            )

    def init(self, key, q, prob):
        return ()

    def _loss_and_aux(self, q, prob, key: jax.Array):
        """Differentiable VarGrad forward path (+ detached log-densities).

        Stop-gradient placement mirrors the reference exactly
        (scoregradelbo.jl:87-94): samples and log-pi are detached; only the
        ``q.log_prob`` term carries gradients.

        Families with WEIGHTED density bookkeeping (PerDatapointMeanField
        under subsampling, weight = N/B) are rejected: VarGrad is quadratic
        in f = log q - log pi, so a weight w rescales the gradient by w^2
        instead of the w the subsampled-ELBO estimator needs — a silently
        wrong step size.  Use the pathwise objectives (RepGradELBO), whose
        estimators are linear in the weighted terms.
        """
        if getattr(q, "weight", 1.0) != 1.0:
            raise ValueError(
                "ScoreGradELBO (VarGrad) does not support weighted-density "
                f"families ({type(q).__name__} with weight={q.weight}): the "
                "quadratic control variate mis-scales the subsampled "
                "gradient. Use RepGradELBO for amortized subsampling."
            )
        q_stop = tree_stop_gradient(q)
        samples = jax.lax.stop_gradient(q_stop.sample(key, self.n_samples))
        # Shard the sample axis over the mesh: per-sample log pi / log q
        # evaluate on the owning device; the VarGrad moments psum-reduce.
        samples = shard_axis0(samples, self.mc_axis)
        log_pi = jax.lax.stop_gradient(
            jax.vmap(prob.log_density)(samples)
        )
        log_q = q.log_prob(samples)
        f = log_q - log_pi
        vargrad = (jnp.mean(jnp.square(f)) - jnp.square(jnp.mean(f))) / 2.0
        info = {
            "elbo": jnp.mean(log_pi - jax.lax.stop_gradient(log_q))
        }
        return vargrad, info

    def loss(self, q, prob, key: jax.Array) -> jax.Array:
        return self._loss_and_aux(q, prob, key)[0]

    def value_and_grad(self, q, prob, key: jax.Array, obj_state=()):
        """(grad, obj_state, info) with info.elbo the plain ELBO estimate."""
        (_, info), grad = jax.value_and_grad(
            self._loss_and_aux, has_aux=True
        )(q, prob, key)
        return grad, obj_state, info

    def estimate_objective(
        self, key: jax.Array, q, prob, n_samples: Optional[int] = None
    ) -> jax.Array:
        """-ELBO estimate (reference: scoregradelbo.jl:64-75)."""
        n = self.n_samples if n_samples is None else n_samples
        samples = shard_axis0(q.sample(key, n), self.mc_axis)
        log_pi = jax.vmap(prob.log_density)(samples)
        log_q = q.log_prob(samples)
        return -jnp.mean(log_pi - log_q)
