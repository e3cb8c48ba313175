"""Entropy estimation strategies for ELBO objectives.

Five strategies that differ only in how the entropy term H(q) enters the AD
graph (reference: src/algorithms/entropy.jl:11-90).  `q_stop` is the same
family with gradients stopped (``jax.lax.stop_gradient`` on the
whole pytree), replacing the reference's detached ``restructure(params)``.

- ClosedFormEntropy:        entropy(q), differentiated.
- ClosedFormEntropyZeroGradient: entropy(q_stop), detached — used with the
  proximal entropy operator.
- MonteCarloEntropy:        -mean log q(z) with z and q both live.
- StickingTheLandingEntropy: -mean log q_stop(z) — only the path derivative
  through the samples remains (Roeder et al. 2017).
- StickingTheLandingEntropyZeroGradient: STL minus entropy(q) plus
  entropy(q_stop), so the entropy gradient has mean zero (for proximal steps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

CLOSED_FORM = "closed_form"
CLOSED_FORM_ZERO_GRAD = "closed_form_zero_grad"
MONTE_CARLO = "monte_carlo"
STL = "stl"
STL_ZERO_GRAD = "stl_zero_grad"

ALL_ENTROPY_ESTIMATORS = (
    CLOSED_FORM,
    CLOSED_FORM_ZERO_GRAD,
    MONTE_CARLO,
    STL,
    STL_ZERO_GRAD,
)

# Estimators compatible with the proximal entropy operator: the gradient of
# the entropy estimate must have mean zero (reference: constructors.jl:122-157
# restricts KLMinRepGradProxDescent to these).
ZERO_GRAD_ESTIMATORS = (CLOSED_FORM_ZERO_GRAD, STL_ZERO_GRAD)


def estimate_entropy(estimator: str, samples: jax.Array, q, q_stop) -> jax.Array:
    """Estimate H(q) given (n, d) reparameterized samples.

    ``samples`` must be live w.r.t. the variational parameters (reparameterized
    draws); ``q_stop`` must be a stop-gradient copy of ``q``.
    """
    if estimator == CLOSED_FORM:
        return q.entropy()
    if estimator == CLOSED_FORM_ZERO_GRAD:
        return q_stop.entropy()
    if estimator == MONTE_CARLO:
        return -jnp.mean(q.log_prob(samples))
    if estimator == STL:
        return -jnp.mean(q_stop.log_prob(samples))
    if estimator == STL_ZERO_GRAD:
        # STL estimate whose gradient has mean zero
        # (reference: entropy.jl:80-90 combined zero-gradient method).
        ent_stl = -jnp.mean(q_stop.log_prob(samples))
        return ent_stl - q.entropy() + q_stop.entropy()
    raise ValueError(f"unknown entropy estimator: {estimator!r}")


# --- Solve-free fast path for reparameterized draws -------------------------
#
# For location-scale draws z = scale·u + location, the whitening solve inside
# log_prob is the identity ``scale⁻¹(z − location) ≡ u`` — and it holds
# IDENTICALLY in the variational parameters (z is defined as scale·u + m with
# u parameter-free), not just numerically.  Consequences:
#
# - MonteCarloEntropy rewrites exactly (same function of the parameters, so
#   same value AND gradient): −mean log q(z) = −mean Σⱼ base.log_prob(uⱼ)
#   + log|det scale|.  Zero solves.
# - STL (−mean log q_stop(z), gradient only through the z path) keeps its
#   value from u but needs ∂z explicitly: ∇_z log q_stop(z) = scaleᵀ⁻¹·s(u)
#   with s the elementwise base score.  A custom VJP computes that with ONE
#   transposed triangular solve in the backward pass — versus the standard
#   path's forward solve plus the transposed solve its autodiff spawns.
#   Value-only evaluations cost zero solves.
#
# Families advertise the path via ``log_det_scale``/``apply_inv_scale_T`` and
# a base ``score`` (supports_fast_entropy); everything else falls back to
# estimate_entropy.


def supports_fast_entropy(q) -> bool:
    return (
        hasattr(q, "apply_inv_scale_T")
        and hasattr(q, "log_det_scale")
        and hasattr(getattr(q, "base", None), "score")
    )


def _base_neg_mean_logp(q, u: jax.Array) -> jax.Array:
    return -jnp.mean(jnp.sum(q.base.log_prob(u), axis=-1))


@jax.custom_vjp
def _stl_entropy_fast(z: jax.Array, u: jax.Array, q_stop) -> jax.Array:
    return _base_neg_mean_logp(q_stop, u) + q_stop.log_det_scale()


def _stl_fast_fwd(z, u, q_stop):
    return _stl_entropy_fast(z, u, q_stop), (u, q_stop)


def _stl_fast_bwd(res, g):
    u, q_stop = res
    n = u.shape[0]
    # ∂(−mean log q_stop(z))/∂z_i = −(1/n)·scaleᵀ⁻¹ s(u_i)
    bar_z = (-g / n) * q_stop.apply_inv_scale_T(q_stop.base.score(u))
    return bar_z.astype(u.dtype), jnp.zeros_like(u), jax.tree.map(
        jnp.zeros_like, q_stop
    )


_stl_entropy_fast.defvjp(_stl_fast_fwd, _stl_fast_bwd)


def estimate_entropy_from_draw(
    estimator: str, z: jax.Array, u: jax.Array, q, q_stop
) -> jax.Array:
    """Entropy estimate from a reparameterized draw ``(z, u)`` with
    ``z = scale·u + location`` — same estimators, same values and gradients
    as ``estimate_entropy``, with the whitening solves eliminated."""
    if estimator == CLOSED_FORM:
        return q.entropy()
    if estimator == CLOSED_FORM_ZERO_GRAD:
        return q_stop.entropy()
    if estimator == MONTE_CARLO:
        return _base_neg_mean_logp(q, u) + q.log_det_scale()
    if estimator == STL:
        return _stl_entropy_fast(z, u, q_stop)
    if estimator == STL_ZERO_GRAD:
        return _stl_entropy_fast(z, u, q_stop) - q.entropy() + q_stop.entropy()
    raise ValueError(f"unknown entropy estimator: {estimator!r}")
