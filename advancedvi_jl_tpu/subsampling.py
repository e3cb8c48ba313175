"""Doubly-stochastic VI: epoch-reshuffled minibatch subsampling.

Redesign of ``ReshufflingBatchSubsampling``
(reference: src/reshuffling.jl:13-60).  The reference drops ragged trailing
batches during optimization specifically to keep prepared-AD shapes stable
(reshuffling.jl:48-53 rationale comment); XLA makes static shapes mandatory,
so here the permutation is truncated to ``n_batches * batchsize`` up front and
reshuffling happens *inside* the jitted step with ``jax.random.permutation``
under ``lax.cond`` — the whole epoch schedule lives on device, with zero host
round trips.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .core.pytree import pytree_dataclass, static_field


@pytree_dataclass
class ReshufflingState:
    perm: jax.Array  # (n_batches * batchsize,) int32
    epoch: jax.Array  # scalar int32, 1-based
    step: jax.Array  # scalar int32, 0-based position within the epoch
    key: jax.Array  # PRNG key driving reshuffles


@pytree_dataclass
class ReshufflingBatchSubsampling:
    """Random-reshuffling batch schedule over ``n_data`` data points.

    Each epoch: draw a fresh permutation, partition into ``n_batches`` full
    batches of ``batchsize`` (trailing remainder dropped — see module
    docstring), visit each batch once, then reshuffle.
    """

    n_data: int = static_field()
    batchsize: int = static_field()

    @property
    def n_batches(self) -> int:
        n = self.n_data // self.batchsize
        if n == 0:
            raise ValueError(
                f"batchsize {self.batchsize} exceeds dataset size {self.n_data}"
            )
        return n

    def __len__(self) -> int:
        return self.n_batches

    def _draw_perm(self, key: jax.Array) -> jax.Array:
        perm = jax.random.permutation(key, self.n_data)
        return perm[: self.n_batches * self.batchsize].astype(jnp.int32)

    def init(self, key: jax.Array) -> ReshufflingState:
        perm_key, next_key = jax.random.split(key)
        return ReshufflingState(
            perm=self._draw_perm(perm_key),
            epoch=jnp.asarray(1, jnp.int32),
            step=jnp.asarray(0, jnp.int32),
            key=next_key,
        )

    def step(
        self, state: ReshufflingState
    ) -> Tuple[jax.Array, ReshufflingState, dict]:
        """Advance one batch; reshuffle at epoch boundaries (jit-safe)."""
        bs, nb = self.batchsize, self.n_batches
        batch = jax.lax.dynamic_slice_in_dim(state.perm, state.step * bs, bs)
        info = {"epoch": state.epoch, "step": state.step + 1}

        next_step = state.step + 1
        is_epoch_end = next_step >= nb

        def reshuffle(_):
            perm_key, next_key = jax.random.split(state.key)
            return ReshufflingState(
                perm=self._draw_perm(perm_key),
                epoch=state.epoch + 1,
                step=jnp.asarray(0, jnp.int32),
                key=next_key,
            )

        def advance(_):
            return ReshufflingState(
                perm=state.perm,
                epoch=state.epoch,
                step=next_step,
                key=state.key,
            )

        new_state = jax.lax.cond(is_epoch_end, reshuffle, advance, None)
        return batch, new_state, info

    def epoch_batches(self, key: jax.Array) -> jax.Array:
        """A full epoch of batches, shape (n_batches, batchsize).

        Used by full-epoch objective sweeps
        (reference: subsampledobjective.jl:47-58).
        """
        return self._draw_perm(key).reshape(self.n_batches, self.batchsize)
