"""Subsampled objective decorator (doubly-stochastic VI).

Redesign of ``SubsampledObjective``
(reference: src/algorithms/subsampledobjective.jl:10-90).  The reference
detours each gradient step through host-side iterator peeling, problem
swapping via ``set_objective_state_problem``, and re-destructuring; here the
whole detour — advance schedule, gather minibatch, inner gradient — is part of
the same jitted step.  Batch shapes are static by construction, so there is
exactly one compiled program for the whole run.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..core.problem import subsample
from ..core.pytree import pytree_dataclass, static_field
from ..subsampling import ReshufflingBatchSubsampling


@pytree_dataclass
class SubsampledObjective:
    objective: Any = static_field()
    subsampling: ReshufflingBatchSubsampling = static_field()

    @property
    def n_samples(self) -> int:
        return self.objective.n_samples

    def init(self, key, q, prob):
        """Objective state = the subsampling schedule state.

        (The reference also conditions AD preparation on a minibatch-typed
        problem, subsampledobjective.jl:22-45; jit tracing on the first step
        does that implicitly here.)  The inner objective's ``init`` runs too
        so its validation (e.g. IWELBO's log_prob requirement, FlowELBO's
        STL-needs-analytic-inverse check) fires early instead of as an
        opaque trace-time error.
        """
        sub_key, inner_key = jax.random.split(key)
        inner_state = self.objective.init(inner_key, q, prob)
        if inner_state != ():
            raise NotImplementedError(
                "SubsampledObjective only composes with stateless "
                f"objectives; {type(self.objective).__name__}.init returned "
                "non-empty state."
            )
        return self.subsampling.init(sub_key)

    def _loss_and_aux(self, q, prob_sub, batch, key):
        # The family subsample happens INSIDE the differentiated function, so
        # for amortized families (per-datapoint parameters, reference:
        # subsampledobjective.jl:81) the gradient of the row gather is a
        # scatter-add back into the FULL parameter arrays — rows outside the
        # minibatch get exact zero gradients.  For the default identity
        # subsample this is the same graph as before.
        q_sub = subsample(q, batch)
        return self.objective._loss_and_aux(q_sub, prob_sub, key)

    def value_and_grad(self, q, prob, key: jax.Array, obj_state):
        batch, sub_state, sub_info = self.subsampling.step(obj_state)
        prob_sub = subsample(prob, batch)
        (_, info), grad = jax.value_and_grad(
            self._loss_and_aux, has_aux=True
        )(q, prob_sub, batch, key)
        info = dict(info)
        info.update(sub_info)
        return grad, sub_state, info

    def estimate_objective(
        self, key: jax.Array, q, prob, n_samples: Optional[int] = None
    ) -> jax.Array:
        """Full-epoch averaged objective (reference: subsampledobjective.jl:47-58)."""
        epoch_key, mc_key = jax.random.split(key)
        batches = self.subsampling.epoch_batches(epoch_key)

        def one_batch(carry, inp):
            i, batch = inp
            prob_sub = subsample(prob, batch)
            q_sub = subsample(q, batch)
            val = self.objective.estimate_objective(
                jax.random.fold_in(mc_key, i), q_sub, prob_sub, n_samples
            )
            return carry + val, None

        n_batches = batches.shape[0]
        acc_dtype = jnp.result_type(*jax.tree.leaves(q))
        total, _ = jax.lax.scan(
            one_batch,
            jnp.zeros((), dtype=acc_dtype),
            (jnp.arange(n_batches), batches),
        )
        return total / n_batches
