"""External (host-callback) targets: non-JAX models behind the protocol.

The reference's ``LogDensityProblems`` protocol accepts ANY Julia callable,
including ones no AD backend can differentiate (capability order 0) or ones
carrying their own gradient oracle (order 1).  The equivalent
bridges arbitrary Python/C++/numpy code into the jitted graph with
``jax.pure_callback``:

- order 0 (value only): usable with ScoreGradELBO / KLMinScoreGradDescent —
  the score-function path never differentiates the target.
- order 1 (value + gradient): the callback returns (value, grad); a
  ``jax.custom_vjp`` stitches the oracle gradient into the outer AD, exactly
  the MixedADLogDensityProblem contract (reference: src/mixedad_logdensity.jl).

Host callbacks serialize through the runtime on every evaluation — this is
for legacy/simulator models, not the hot path; vmap over samples batches into
ONE host call (``vmap_method="expand_dims"``) to amortize the round trip.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax

from .problem import ORDER_GRAD, ORDER_VALUE_ONLY
from .pytree import pytree_dataclass, static_field


@pytree_dataclass
class ExternalTarget:
    """Wrap a host Python function as a VI target.

    ``host_fn(theta_batch: np.ndarray (..., d)) -> np.ndarray (...)`` for
    order 0; for order 1 also supply ``host_grad_fn`` with the same batching.
    """

    host_fn: Callable = static_field()
    dim: int = static_field()
    host_grad_fn: Callable = static_field(default=None)

    def order(self) -> int:
        return ORDER_GRAD if self.host_grad_fn is not None else ORDER_VALUE_ONLY

    def log_density(self, theta: jax.Array) -> jax.Array:
        if self.host_grad_fn is not None:
            return _external_ld_with_grad(
                theta, self.host_fn, self.host_grad_fn
            )
        out_shape = jax.ShapeDtypeStruct(theta.shape[:-1], theta.dtype)
        return jax.pure_callback(
            self.host_fn, out_shape, theta, vmap_method="expand_dims"
        )

    def log_density_and_grad(self, theta: jax.Array):
        v = self.log_density(theta)
        if self.host_grad_fn is None:
            raise ValueError("external target has no gradient oracle")
        g = jax.pure_callback(
            self.host_grad_fn,
            jax.ShapeDtypeStruct(theta.shape, theta.dtype),
            theta,
            vmap_method="expand_dims",
        )
        return v, g


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def _external_ld_with_grad(theta, host_fn, host_grad_fn):
    out_shape = jax.ShapeDtypeStruct(theta.shape[:-1], theta.dtype)
    return jax.pure_callback(
        host_fn, out_shape, theta, vmap_method="expand_dims"
    )


def _external_fwd(theta, host_fn, host_grad_fn):
    v = _external_ld_with_grad(theta, host_fn, host_grad_fn)
    g = jax.pure_callback(
        host_grad_fn,
        jax.ShapeDtypeStruct(theta.shape, theta.dtype),
        theta,
        vmap_method="expand_dims",
    )
    return v, g


def _external_bwd(host_fn, host_grad_fn, g_res, ct):
    return (ct[..., None] * g_res if g_res.ndim > 1 else ct * g_res,)


_external_ld_with_grad.defvjp(_external_fwd, _external_bwd)
