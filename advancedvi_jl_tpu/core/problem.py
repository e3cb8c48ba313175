"""Target log-density protocol (analogue of LogDensityProblems).

The reference consumes targets through the ``LogDensityProblems`` protocol:
``logdensity``, ``logdensity_and_gradient``, ``logdensity_gradient_and_hessian``,
``dimension``, ``capabilities`` (reference: src/AdvancedVI.jl layer L0, and the
MixedAD wrapper at src/mixedad_logdensity.jl:9-34).

Design: a target is any pytree object exposing

- ``log_density(theta) -> scalar``   (must be jax-traceable)
- ``dim`` property
- ``order()`` capability: 0 = value only (not AD-able, e.g. external oracle
  without gradients), 1 = gradient oracle available (Stein-identity paths used
  for Hessians), ``ORDER_JAX`` = fully jax-differentiable (gradients *and*
  Hessians come from ``jax.grad`` / ``jax.hessian``).
- optional ``log_density_and_grad(theta)`` for order>=1 oracle targets
- optional ``subsample(indices)`` for doubly-stochastic VI
  (reference hook: src/AdvancedVI.jl:303-319)

There is exactly one AD (JAX), so the reference's five-backend AD-glue layer
(src/AdvancedVI.jl:27-111 + ext/AdvancedVI{Enzyme,Mooncake,ReverseDiff}Ext.jl)
collapses to this file: targets that bring their own gradient oracle are
wrapped with ``jax.custom_vjp`` (`CustomGradTarget`), which is the single
Equivalent of ``MixedADLogDensityProblem`` + its three backend
extensions.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from .pytree import pytree_dataclass, static_field

# Capability orders, mirroring LogDensityProblems.LogDensityOrder{K}().
ORDER_VALUE_ONLY = 0
ORDER_GRAD = 1
ORDER_HESS = 2
ORDER_JAX = 100  # fully traceable: any-order AD available


def order_of(prob: Any) -> int:
    """Differentiation capability of a target (default: fully jax-AD-able)."""
    fn = getattr(prob, "order", None)
    if fn is None:
        return ORDER_JAX
    return fn() if callable(fn) else int(fn)


def dim_of(prob: Any) -> int:
    d = getattr(prob, "dim")
    return d() if callable(d) else int(d)


def log_density(prob: Any, theta: jax.Array) -> jax.Array:
    return prob.log_density(theta)


def log_density_and_grad(prob: Any, theta: jax.Array):
    """Value and gradient, preferring a target-supplied oracle."""
    fn = getattr(prob, "log_density_and_grad", None)
    if fn is not None:
        return fn(theta)
    return jax.value_and_grad(prob.log_density)(theta)


def log_density_grad_and_hess(prob: Any, theta: jax.Array):
    """Value, gradient, and Hessian (order-2 path).

    Mirrors ``LogDensityProblems.logdensity_gradient_and_hessian`` used by the
    measure-space algorithms (reference:
    src/algorithms/gauss_expected_grad_hess.jl:59-78).
    """
    fn = getattr(prob, "log_density_grad_and_hess", None)
    if fn is not None:
        return fn(theta)
    v, g = log_density_and_grad(prob, theta)
    h = jax.hessian(prob.log_density)(theta)
    return v, g, h


def validate_pytree_target(prob: Any) -> None:
    """Readable early error for non-jit-compatible targets.

    Targets are threaded through jit / lax.scan as part of the algorithm
    state; plain Python objects fail deep inside jit with an opaque pytree
    error.  Accepts arrays, Python scalars, and numpy scalars/arrays.
    """
    import numpy as _np

    for leaf in jax.tree.leaves(prob):
        if isinstance(
            leaf, (jax.Array, jnp.ndarray, int, float, bool, _np.ndarray, _np.generic)
        ):
            continue
        raise TypeError(
            f"Target {type(prob).__name__} is not a jit-compatible "
            f"pytree (leaf of type {type(leaf).__name__}). Define "
            "targets with @pytree_dataclass (static_field for "
            "non-array config) or use fn_target(...)."
        )


def subsample(prob_or_q: Any, indices: jax.Array) -> Any:
    """Restrict a target (or an amortized q) to a minibatch.

    Analogue of ``AdvancedVI.subsample`` (reference:
    src/AdvancedVI.jl:303-319).  The returned object must have the *same pytree
    structure family* for all batches (static shapes for XLA) and must rescale
    the likelihood by ``n_data / batch_size`` to stay an unbiased estimator of
    the full log-joint (documented reference pitfall:
    docs/src/tutorials/subsampling.md).  Default: identity (full batch).
    """
    fn = getattr(prob_or_q, "subsample", None)
    if fn is None:
        return prob_or_q
    return fn(indices)


# ---------------------------------------------------------------------------
# Custom-gradient targets (MixedADLogDensityProblem analogue)
# ---------------------------------------------------------------------------


from functools import partial


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _oracle_log_density(theta, data, value_closure, vag_closure):
    return value_closure(theta, data)


def _oracle_fwd(theta, data, value_closure, vag_closure):
    v, g = vag_closure(theta, data)
    return v, (g, data)


def _oracle_bwd(value_closure, vag_closure, residual, ct):
    g, data = residual
    data_ct = jax.tree.map(jnp.zeros_like, data)
    return (ct * g, data_ct)


_oracle_log_density.defvjp(_oracle_fwd, _oracle_bwd)


@pytree_dataclass
class CustomGradTarget:
    """Wrap a target that supplies its own gradient oracle.

    The outer AD (differentiating the ELBO w.r.t. variational parameters)
    routes through the supplied ``value_and_grad_fn`` at the model boundary via
    ``jax.custom_vjp`` — pullback is ``ct * grad`` exactly as the reference's
    ChainRules rrule (reference: src/mixedad_logdensity.jl:23-34).

    ``data`` is an arbitrary pytree threaded through (so subsampled variants
    keep working under jit); the closures are static.  Supplying
    ``value_grad_and_hess_fn`` raises the capability to order 2, enabling the
    exact-Hessian path of the measure-space algorithms (the reference's
    ``logdensity_gradient_and_hessian``).
    """

    data: Any
    value_fn: Callable = static_field()
    value_and_grad_fn: Callable = static_field()
    dim: int = static_field()
    capability: int = static_field(default=ORDER_GRAD)
    value_grad_and_hess_fn: Callable = static_field(default=None)

    def order(self) -> int:
        if self.value_grad_and_hess_fn is not None:
            return max(self.capability, ORDER_HESS)
        return self.capability

    def log_density(self, theta: jax.Array) -> jax.Array:
        return _oracle_log_density(
            theta, self.data, self.value_fn, self.value_and_grad_fn
        )

    def log_density_and_grad(self, theta: jax.Array):
        return self.value_and_grad_fn(theta, self.data)

    def log_density_grad_and_hess(self, theta: jax.Array):
        if self.value_grad_and_hess_fn is None:
            raise ValueError("target has no Hessian oracle (order < 2)")
        return self.value_grad_and_hess_fn(theta, self.data)


def maybe_wrap_custom_grad(prob: Any) -> Any:
    """Use a target's own gradient oracle when it has one.

    Mirrors the reference's decision in ``RepGradELBO.init``: if capability
    >= order 1, wrap in the MixedAD problem so the existing
    ``logdensity_and_gradient`` is reused (reference:
    src/algorithms/repgradelbo.jl:41-70).  In JAX, targets constructed from
    pure jnp code are already optimal, so this only rewraps true oracles.
    """
    if isinstance(prob, CustomGradTarget):
        return prob
    if order_of(prob) == ORDER_VALUE_ONLY:
        raise ValueError(
            "Target has capability order 0 (value-only, not differentiable). "
            "Reparameterization-gradient objectives require a differentiable "
            "target; use ScoreGradELBO / KLMinScoreGradDescent instead."
        )
    return prob


# ---------------------------------------------------------------------------
# Simple functional target
# ---------------------------------------------------------------------------


@pytree_dataclass
class FnTarget:
    """A target built from a plain jax-traceable function ``f(theta, data)``."""

    data: Any
    fn: Callable = static_field()
    dim: int = static_field()

    def order(self) -> int:
        return ORDER_JAX

    def log_density(self, theta: jax.Array) -> jax.Array:
        return self.fn(theta, self.data)


def fn_target(fn: Callable, dim: int, data: Any = None) -> FnTarget:
    return FnTarget(data=data, fn=fn, dim=dim)
