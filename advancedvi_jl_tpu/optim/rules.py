"""Parameter-free step-size rules as optax gradient transformations.

Equivalents of the reference's ``Optimisers.jl`` rules
(reference: src/optimization/rules.jl):

- DoWG (:17-34): distance-over-weighted-gradients,  eta = r^2 / sqrt(v),
  r = max(||x - x0||, r),  v += r^2 ||g||^2.
- DoG  (:48-64): distance-over-gradients,  eta = r / sqrt(v),  v += ||g||^2.
- COCOB (:78-96): COCOB-Backprop continuous coin betting (elementwise).

The reference flattens all parameters into one vector, so DoG/DoWG norms are
global; here they are computed over the whole pytree (identical semantics,
no flattening).  State is a pure pytree — trivially replicable/shardable over
a device mesh and checkpointable.

All rules follow optax conventions: ``update`` returns the *delta added* to
params (``params + updates``), i.e. ``-eta * g`` for a descent-type rule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from ..core.pytree import tree_global_norm_sq


class DoWGState(NamedTuple):
    x0: optax.Params
    v: jax.Array  # accumulated weighted squared gradient norms
    r: jax.Array  # running distance estimate


class DoGState(NamedTuple):
    x0: optax.Params
    v: jax.Array
    r: jax.Array


class COCOBState(NamedTuple):
    L: optax.Updates  # per-coordinate max absolute gradient
    G: optax.Updates  # per-coordinate absolute gradient sum
    R: optax.Updates  # per-coordinate "reward"
    theta: optax.Updates  # per-coordinate summed negative gradients
    x1: optax.Params  # initial parameters


class DescentState(NamedTuple):
    """Constant-step-size descent; lr kept in state so the proximal entropy
    operator can extract it (reference: proximal_location_scale_entropy.jl:30)."""

    lr: jax.Array


def _norm(tree) -> jax.Array:
    return jnp.sqrt(tree_global_norm_sq(tree))


def dowg(alpha: float = 1e-6) -> optax.GradientTransformation:
    """DoWG (reference: rules.jl:17-34).  `alpha` scales the initial distance
    guess: r0 = alpha * (1 + ||x0||)."""

    def init_fn(params):
        dtype = jnp.result_type(*jax.tree.leaves(params))
        r0 = jnp.asarray(alpha, dtype) * (1.0 + _norm(params).astype(dtype))
        return DoWGState(
            x0=jax.tree.map(jnp.copy, params),
            v=jnp.zeros((), dtype),
            r=r0,
        )

    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("dowg requires params")
        dist = _norm(jax.tree.map(jnp.subtract, params, state.x0))
        r = jnp.maximum(dist, state.r)
        r2 = r * r
        v = state.v + r2 * tree_global_norm_sq(updates)
        eta = r2 / jnp.sqrt(v)
        new_updates = jax.tree.map(lambda g: -eta * g, updates)
        return new_updates, DoWGState(x0=state.x0, v=v, r=r)

    return optax.GradientTransformation(init_fn, update_fn)


def dog(alpha: float = 1e-6) -> optax.GradientTransformation:
    """DoG (reference: rules.jl:48-64)."""

    def init_fn(params):
        dtype = jnp.result_type(*jax.tree.leaves(params))
        r0 = jnp.asarray(alpha, dtype) * (1.0 + _norm(params).astype(dtype))
        return DoGState(
            x0=jax.tree.map(jnp.copy, params),
            v=jnp.zeros((), dtype),
            r=r0,
        )

    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("dog requires params")
        dist = _norm(jax.tree.map(jnp.subtract, params, state.x0))
        r = jnp.maximum(dist, state.r)
        v = state.v + tree_global_norm_sq(updates)
        eta = r / jnp.sqrt(v)
        new_updates = jax.tree.map(lambda g: -eta * g, updates)
        return new_updates, DoGState(x0=state.x0, v=v, r=r)

    return optax.GradientTransformation(init_fn, update_fn)


def cocob(alpha: float = 100.0) -> optax.GradientTransformation:
    """COCOB-Backprop (reference: rules.jl:78-96), elementwise coin betting.

    Per coordinate: L = max(L, |g|); G += |g|; R = max(R + (x - x1)(-g), 0);
    theta += -g; new x = x1 + theta (L + R) / (L max(G + L, alpha L)).
    """

    def init_fn(params):
        zeros = jax.tree.map(jnp.zeros_like, params)
        return COCOBState(
            L=zeros,
            G=jax.tree.map(jnp.zeros_like, params),
            R=jax.tree.map(jnp.zeros_like, params),
            theta=jax.tree.map(jnp.zeros_like, params),
            x1=jax.tree.map(jnp.copy, params),
        )

    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("cocob requires params")

        def leafwise(g, L, G, R, theta, x1, x):
            a = jnp.asarray(alpha, g.dtype)
            L_new = jnp.maximum(L, jnp.abs(g))
            G_new = G + jnp.abs(g)
            R_new = jnp.maximum(R + (x - x1) * (-g), 0.0)
            theta_new = theta + (-g)
            denom = L_new * jnp.maximum(G_new + L_new, a * L_new)
            # Coordinates that have only ever seen zero gradients (e.g. the
            # inert upper triangle of a full-rank scale) keep x = x1.
            bet = jnp.where(denom > 0, theta_new / jnp.where(denom > 0, denom, 1.0), 0.0)
            x_target = x1 + bet * (L_new + R_new)
            return x_target - x, L_new, G_new, R_new, theta_new

        flat = jax.tree.map(
            leafwise, updates, state.L, state.G, state.R, state.theta,
            state.x1, params,
        )
        # unzip the per-leaf 5-tuples
        treedef = jax.tree.structure(params)
        leaves = treedef.flatten_up_to(flat)
        upd, L, G, R, theta = (
            treedef.unflatten([lv[i] for lv in leaves]) for i in range(5)
        )
        return upd, COCOBState(L=L, G=G, R=R, theta=theta, x1=state.x1)

    return optax.GradientTransformation(init_fn, update_fn)


def descent(lr: float) -> optax.GradientTransformation:
    """Plain SGD whose step size is visible in state (for the proximal op)."""

    def init_fn(params):
        dtype = jnp.result_type(*jax.tree.leaves(params))
        return DescentState(lr=jnp.asarray(lr, dtype))

    def update_fn(updates, state, params=None):
        return jax.tree.map(lambda g: -state.lr * g, updates), state

    return optax.GradientTransformation(init_fn, update_fn)


def stepsize_from_opt_state(opt_state) -> Optional[jax.Array]:
    """Extract the current scalar step size from an optimizer state.

    Analogue of ``stepsize_from_optimizer_state``
    (reference: proximal_location_scale_entropy.jl:26-42): supported for
    Descent / DoG / DoWG only.  Searches the (possibly chained) state tuple.
    """
    states = opt_state if isinstance(opt_state, tuple) and not hasattr(
        opt_state, "_fields"
    ) else (opt_state,)
    for s in states:
        if isinstance(s, DescentState):
            return s.lr
        if isinstance(s, DoGState):
            return s.r / jnp.sqrt(s.v)
        if isinstance(s, DoWGState):
            return (s.r * s.r) / jnp.sqrt(s.v)
    return None
