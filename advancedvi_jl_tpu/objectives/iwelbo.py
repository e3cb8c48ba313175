"""Importance-weighted ELBO (IWAE bound) with doubly-reparameterized gradients.

Beyond the reference's surface, but squarely in its cited literature: the
reference's flows tutorial cites Agrawal, Sheldon & Domke (2020) "Advances in
black-box VI: normalizing flows, importance weighting, and optimization"
(reference: docs/src/tutorials/flows.md footnote ASD2020) without shipping
the importance-weighting part.  This objective is that part:

    IW-ELBO_k = E_{z_1..k ~ q} [ log (1/k) sum_j p(z_j) / q(z_j) ]

a tighter lower bound than the ELBO, monotone in k (Burda et al. 2016).

Gradients:
- ``dreg=False``: plain reparameterized IWAE gradient (differentiate the
  logsumexp with live q density).
- ``dreg=True`` (default): the doubly-reparameterized (DReG) estimator
  (Tucker et al. 2019) — the score-function term of the total gradient is
  replaced by its reparameterized form, yielding

      grad = E[ sum_j w~_j^2  d(log p(z_j) - log q_stop(z_j))/dz_j  dz_j/dphi ]

  with w~ the self-normalized weights.  Implemented as a surrogate loss
  ``-sum_j sg(w~_j)^2 (log p - log q_stop)(z_j)`` with live reparameterized
  z, so one ``jax.grad`` produces it.  DReG removes the signal-to-noise decay
  of the plain estimator as k grows (Rainforth et al. 2018) — measured in
  tests/test_iwelbo.py.

Design notes: the k importance samples are one batched draw + one vmapped
log-density — the same fused-program shape as RepGradELBO — and shard over
the "mc" mesh axis (the logsumexp reduces with a psum).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..core.problem import maybe_wrap_custom_grad
from ..core.pytree import pytree_dataclass, static_field, tree_stop_gradient
from ..parallel.mesh import shard_axis0


@pytree_dataclass
class IWELBO:
    """Importance-weighted ELBO objective (drop-in for ParamSpaceSGD).

    Args:
      n_samples: k, the number of importance samples per step.
      dreg: doubly-reparameterized gradient (default) vs plain IWAE gradient.
      mc_axis: optional mesh axis to shard the importance-sample dimension.

    Requires a family with reparameterized ``sample`` and ``log_prob``
    (location-scale, low-rank, coupling flows — not planar/radial flows).
    """

    n_samples: int = static_field(default=8)
    dreg: bool = static_field(default=True)
    mc_axis: Optional[str] = static_field(default=None)

    def init(self, key, q, prob):
        self._check_family(q)
        return ()

    @staticmethod
    def _check_family(q) -> None:
        if not hasattr(q, "log_prob"):
            raise ValueError(
                "IWELBO requires a family with log_prob (importance weights "
                f"need the density at drawn points); {type(q).__name__} "
                "has none."
            )
        if getattr(q, "weight", 1.0) != 1.0:
            # log w = log p - weight * log q is NOT the importance weight of
            # any distribution — weighted-density bookkeeping is only valid
            # for estimators linear in log q (the pathwise ELBOs).
            raise ValueError(
                "IWELBO does not support weighted-density families "
                f"({type(q).__name__} with weight={q.weight}); use "
                "RepGradELBO for amortized subsampling."
            )

    def _loss_and_aux(self, q, prob, key: jax.Array):
        self._check_family(q)
        prob = maybe_wrap_custom_grad(prob)
        k = self.n_samples
        q_stop = tree_stop_gradient(q)
        z = shard_axis0(q.sample(key, k), self.mc_axis)
        logp = jax.vmap(prob.log_density)(z)
        log_k = jnp.log(jnp.asarray(k, logp.dtype))

        if self.dreg:
            # phi enters ONLY through z: frozen density at live samples.
            logw = logp - q_stop.log_prob(z)
            w_norm = jax.lax.stop_gradient(jax.nn.softmax(logw))
            # At k=1 this reduces exactly to the STL ELBO surrogate
            # (w~ = 1, loss = -(log p - log q_stop)).
            loss = -jnp.sum(jnp.square(w_norm) * logw)
            iwelbo = jax.lax.stop_gradient(
                jax.nn.logsumexp(logw) - log_k
            )
        else:
            logw = logp - q.log_prob(z)
            bound = jax.nn.logsumexp(logw) - log_k
            loss = -bound
            iwelbo = jax.lax.stop_gradient(bound)
        return loss, {"elbo": iwelbo}

    def loss(self, q, prob, key: jax.Array) -> jax.Array:
        return self._loss_and_aux(q, prob, key)[0]

    def value_and_grad(self, q, prob, key: jax.Array, obj_state=()):
        (_, info), grad = jax.value_and_grad(
            self._loss_and_aux, has_aux=True
        )(q, prob, key)
        return grad, obj_state, info

    def estimate_objective(
        self, key: jax.Array, q, prob, n_samples: Optional[int] = None
    ) -> jax.Array:
        """Negative IW-ELBO_k estimate (lower is better, like -ELBO)."""
        k = self.n_samples if n_samples is None else n_samples
        z = shard_axis0(q.sample(key, k), self.mc_axis)
        logw = jax.vmap(prob.log_density)(z) - q.log_prob(z)
        return -(jax.nn.logsumexp(logw) - jnp.log(jnp.asarray(k, logw.dtype)))


def KLMinIWRepGradDescent(
    n_samples: int = 8,
    dreg: bool = True,
    optimizer=None,
    averager=None,
    operator=None,
    subsampling=None,
    mc_axis: Optional[str] = None,
):
    """SGD on the importance-weighted ELBO (IWAE bound; DReG by default).

    Same defaults as KLMinRepGradDescent (DoWG + polynomial averaging).
    """
    import optax  # noqa: F401  (parity with sibling constructors)

    from ..algorithms.paramspace import ParamSpaceSGD
    from ..objectives.subsampled import SubsampledObjective
    from ..optim.averaging import PolynomialAveraging
    from ..optim.operators import IdentityOperator
    from ..optim.rules import dowg

    objective = IWELBO(n_samples=n_samples, dreg=dreg, mc_axis=mc_axis)
    if subsampling is not None:
        objective = SubsampledObjective(
            objective=objective, subsampling=subsampling
        )
    return ParamSpaceSGD(
        objective=objective,
        optimizer=optimizer if optimizer is not None else dowg(),
        averager=averager if averager is not None else PolynomialAveraging(),
        operator=operator if operator is not None else IdentityOperator(),
    )
