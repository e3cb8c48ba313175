"""Reparameterization-gradient ELBO (the flagship hot path).

Redesign of ``RepGradELBO``
(reference: src/algorithms/repgradelbo.jl:21-177).  The reference's per-step
pipeline — restructure params, draw samples one column at a time, loop the
model log-density over columns, AD through a prepared tape — becomes ONE pure
jittable function:

    sample (batched, one matmul) -> vmap log_density -> entropy -> -elbo

differentiated with ``jax.grad``.  The Monte-Carlo sample axis is the
shardable axis: under a device mesh the (n_samples, d) draw is annotated with
a sharding constraint on the "mc" axis (see parallel/), and the means reduce
with XLA collectives.  No host round trips, no prepared-tape machinery
(jit compilation caching keyed on shapes replaces ``_prepare_gradient``,
reference: src/AdvancedVI.jl:27-111).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..core.problem import maybe_wrap_custom_grad
from ..core.pytree import pytree_dataclass, static_field, tree_stop_gradient
from .entropy import (
    CLOSED_FORM,
    estimate_entropy,
    estimate_entropy_from_draw,
    supports_fast_entropy,
)


def _constrain_mc(samples: jax.Array, mc_axis: Optional[str]) -> jax.Array:
    """Annotate the sample axis for mesh sharding (no-op outside a mesh)."""
    from ..parallel.mesh import shard_axis0

    return shard_axis0(samples, mc_axis)


@pytree_dataclass
class RepGradELBO:
    """ELBO with the reparameterization gradient.

    Args:
      n_samples: Monte-Carlo samples per gradient estimate.
      entropy: one of the five entropy strategies (objectives/entropy.py).
      mc_axis: optional mesh axis name to shard the sample dimension over.
    """

    n_samples: int = static_field(default=1)
    entropy: str = static_field(default=CLOSED_FORM)
    mc_axis: Optional[str] = static_field(default=None)
    # Rematerialize the per-sample energy in the backward pass instead of
    # storing activations — trades FLOPs for HBM on large models (deep BNNs
    # with many samples), the standard jax.checkpoint pattern.
    remat: bool = static_field(default=False)
    # Antithetic sampling (beyond the reference surface): draw n/2 samples
    # and mirror them through the location, z' = 2 m - z. Valid for
    # location-scale families with a symmetric base (z = C u + m with
    # -u ~ u); the estimator stays unbiased and the energy-term variance
    # drops substantially when log pi is near-linear over q's support.
    antithetic: bool = static_field(default=False)
    # Solve-free entropy fast path: for families exposing the base draw
    # (z = scale·u + location), the MC/STL whitening solve is eliminated via
    # the identity scale⁻¹(z−m) ≡ u (see entropy.estimate_entropy_from_draw —
    # identical values and gradients).  Opt-out knob for A/B benchmarking.
    fast_entropy: bool = static_field(default=True)

    def init(self, key, q, prob):
        return ()  # stateless: jit caching replaces AD preparation

    def _check_antithetic(self, q, n: int) -> None:
        if n % 2 != 0:
            raise ValueError(
                f"antithetic sampling requires an even n_samples, got {n}"
            )
        if not hasattr(q, "location"):
            raise ValueError(
                "antithetic sampling requires a location-scale family "
                f"(symmetric base); got {type(q).__name__}"
            )
        base = getattr(q, "base", None)
        if base is not None and not (
            hasattr(base, "symmetric") and base.symmetric()
        ):
            # z' = 2m - z has the law of q only when -u ~ u for the base;
            # an asymmetric base would silently bias the estimator.
            raise ValueError(
                "antithetic sampling requires a symmetric base distribution "
                f"(-u ~ u); {type(base).__name__} does not declare "
                "symmetric() = True."
            )

    def _draw(self, q, key: jax.Array, n: Optional[int] = None) -> jax.Array:
        n = self.n_samples if n is None else n
        if not self.antithetic:
            return q.sample(key, n)
        self._check_antithetic(q, n)
        z = q.sample(key, n // 2)
        return jnp.concatenate([z, 2.0 * q.location - z], axis=0)

    def _draw_with_base(self, q, key: jax.Array, n: Optional[int] = None):
        """(z, u) draw for the fast entropy path; preconditions on the family
        match _draw (the antithetic mirror z' = 2m − z has base draw −u)."""
        n = self.n_samples if n is None else n
        if not self.antithetic:
            return q.sample_with_base(key, n)
        self._check_antithetic(q, n)
        z, u = q.sample_with_base(key, n // 2)
        return (
            jnp.concatenate([z, 2.0 * q.location - z], axis=0),
            jnp.concatenate([u, -u], axis=0),
        )

    def _use_fast(self, q) -> bool:
        return (
            self.fast_entropy
            and supports_fast_entropy(q)
            and hasattr(q, "sample_with_base")
        )

    def loss(self, q, prob, key: jax.Array) -> jax.Array:
        """Differentiable forward path: -ELBO estimate.

        Mirrors ``estimate_repgradelbo_ad_forward``
        (reference: repgradelbo.jl:142-149): q_stop is the stop-gradient copy
        used by the STL/proximal entropy strategies.
        """
        q_stop = tree_stop_gradient(q)
        if self._use_fast(q):
            samples, u = self._draw_with_base(q, key)
            samples = _constrain_mc(samples, self.mc_axis)
            u = _constrain_mc(u, self.mc_axis)
            ent = estimate_entropy_from_draw(
                self.entropy, samples, u, q, q_stop
            )
        else:
            samples = self._draw(q, key)
            samples = _constrain_mc(samples, self.mc_axis)
            ent = estimate_entropy(self.entropy, samples, q, q_stop)
        log_density = prob.log_density
        if self.remat:
            log_density = jax.checkpoint(log_density)
        energy = jnp.mean(jax.vmap(log_density)(samples))
        return -(energy + ent)

    def _loss_and_aux(self, q, prob, key: jax.Array):
        """(loss, info) — the uniform differentiable contract every objective
        exposes so decorators (SubsampledObjective) can compose gradients
        through family transformations (e.g. amortized-q subsampling)."""
        nelbo = self.loss(q, maybe_wrap_custom_grad(prob), key)
        return nelbo, {"elbo": -nelbo}

    def value_and_grad(self, q, prob, key: jax.Array, obj_state=()):
        """One gradient estimate; returns (grad_pytree, obj_state, info).

        Analogue of ``estimate_gradient!`` (reference: repgradelbo.jl:151-177)
        with the DiffResults buffer replaced by a returned pytree.
        """
        (_, info), grad = jax.value_and_grad(
            self._loss_and_aux, has_aux=True
        )(q, prob, key)
        return grad, obj_state, info

    def estimate_objective(
        self, key: jax.Array, q, prob, n_samples: Optional[int] = None
    ) -> jax.Array:
        """-ELBO point estimate (no gradient), reference: repgradelbo.jl:112-118."""
        n = self.n_samples if n_samples is None else n_samples
        if self.antithetic and n % 2 == 0:
            # Antithetic pairing applies for any even n (plain sampling only
            # for odd n) so the estimator does not silently switch when the
            # caller's n happens to differ from the training n_samples.
            samples = self._draw(q, key, n)
        else:
            samples = q.sample(key, n)
        q_stop = tree_stop_gradient(q)
        ent = estimate_entropy(self.entropy, samples, q, q_stop)
        energy = jnp.mean(jax.vmap(prob.log_density)(samples))
        return -(energy + ent)
