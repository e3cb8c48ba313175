"""Batched (vmapped) VI chains: many independent optimizations in one program.

A capability with no reference analogue: run K restarts / replicates of the
same algorithm simultaneously by vmapping the step over a leading chain
axis.  All per-chain (d,)-sized ops become (K, d)-sized — turning the
launch-bound tiny-model step into real vector/matrix work at almost the
same step time (aggregate chain-steps/s on the H100 are in PERF.md).

The target is NOT vmapped (in_axes=None for ``state.prob``), so the dataset
is shared across chains, not copied.  Chains differ in their PRNG keys and/or
initial variational parameters (and, since optimizer state is a pytree,
per-chain hyperparameters stored as arrays also work).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def _state_axes(state):
    """in/out axis tree for vmapping an algorithm state: chain axis 0 on
    everything except the shared target and the scalar iteration counter
    (vmap axis trees are prefixes: a single 0/None covers a whole subtree)."""
    kwargs = {}
    for f in dataclasses.fields(state):
        kwargs[f.name] = None if f.name in ("prob", "iteration") else 0
    return type(state)(**kwargs)


# Fields a chain jitter perturbs, in priority order: location-scale/low-rank
# families, mixtures (per-component locations), flows (base location).
_JITTER_FIELDS = ("location", "locations", "base_location")


def _jitter_field(q) -> str:
    for f in _JITTER_FIELDS:
        if hasattr(q, f):
            return f
    raise ValueError(
        f"jitter != 0 requires the family to expose one of {_JITTER_FIELDS}; "
        f"{type(q).__name__} has none — pass a pre-stacked q_init with "
        "stacked=True for custom per-chain initializations."
    )


def init_chains(
    key: jax.Array,
    algorithm,
    q_init,
    prob,
    n_chains: int,
    jitter: float = 0.0,
    stacked: bool = False,
):
    """Initialize K chains: distinct PRNG keys, optionally jittered inits.

    ``stacked=True`` declares ``q_init`` pre-stacked (every leaf carries a
    leading chain axis of size ``n_chains``) for fully custom per-chain
    initializations — an explicit flag, because leading-axis heuristics
    misread mixtures (whose ``locations`` is already 2-D per chain) and
    flows.  ``jitter`` perturbs the family's location field (works for
    location-scale, low-rank, mixture, and flow families).
    """
    keys = jax.random.split(key, n_chains)
    if stacked:
        lead = {
            (x.shape[0] if x.ndim else None) for x in jax.tree.leaves(q_init)
        }
        if lead != {n_chains}:
            raise ValueError(
                f"stacked q_init must have a leading chain axis of "
                f"{n_chains} on every leaf; got leading sizes "
                f"{sorted(lead, key=str)} (None = 0-d leaf, which cannot "
                "carry a chain axis)"
            )
        qs = q_init
    else:
        # Guard against the pre-round-2 calling convention (pre-stacked
        # location-scale q without the flag): a 2-D `location` on a family
        # whose location is 1-D always means a leading chain axis.
        loc = getattr(q_init, "location", None)
        if loc is not None and loc.ndim >= 2:
            raise ValueError(
                "q_init.location has a leading batch axis "
                f"{loc.shape}; for pre-stacked per-chain initializations "
                "pass stacked=True."
            )
        field = _jitter_field(q_init) if jitter != 0.0 else None

        def make_q(k):
            if jitter == 0.0:
                return q_init
            loc = getattr(q_init, field)
            noise = jax.random.normal(k, loc.shape, loc.dtype)
            return q_init.replace(**{field: loc + jitter * noise})

        qs = jax.vmap(make_q)(keys)

    def init_one(k, q):
        return algorithm.init(k, q, prob)

    # The target inside each state would be stacked by a naive vmap; init
    # once to get the structure, then vmap with prob held out.
    proto = algorithm.init(keys[0], jax.tree.map(lambda x: x[0], qs), prob)
    axes = _state_axes(proto)
    states = jax.vmap(init_one, in_axes=(0, 0), out_axes=axes)(keys, qs)
    return states, axes


def step_chains(algorithm, states, axes):
    """One vmapped step for all chains; returns (states, stacked info)."""
    return jax.vmap(algorithm.step, in_axes=(axes,), out_axes=(axes, 0))(
        states
    )


def optimize_chains(
    key: jax.Array,
    algorithm,
    max_iter: int,
    prob,
    q_init,
    n_chains: int,
    jitter: float = 0.0,
    stacked: bool = False,
    states=None,
    axes=None,
):
    """Run K independent optimizations; returns (outputs, final_infos, states, axes).

    ``outputs`` is the family pytree with a leading chain axis.  To pick the
    best chain, score with the NEGATED objective (``estimate_objective``
    returns the negative ELBO — lower is better — while ``best_chain`` takes
    the argmax)::

        scores = jax.vmap(
            lambda q: -alg.estimate_objective(key, q, prob, n_samples)
        )(outputs)
        q_best = best_chain(outputs, scores)
    """
    if states is None:
        states, axes = init_chains(
            key, algorithm, q_init, prob, n_chains, jitter, stacked
        )

    def body(carry, _):
        new_states, info = step_chains(algorithm, carry, axes)
        return new_states, info

    def scan_fn(states):
        return jax.lax.scan(body, states, None, length=max_iter)

    states, infos = jax.jit(scan_fn)(states)
    outputs = jax.vmap(
        algorithm.output, in_axes=(axes,), out_axes=0
    )(states)
    last_info = {k: v[-1] for k, v in infos.items()}
    return outputs, last_info, states, axes


def best_chain(outputs, scores: jax.Array):
    """Select the chain pytree slice with the best (highest) score."""
    i = jnp.argmax(scores)
    return jax.tree.map(lambda x: x[i], outputs)
