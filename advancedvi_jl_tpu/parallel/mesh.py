"""Device-mesh construction and sharded execution for VI workloads.

The reference is strictly single-process (SURVEY.md §2.7: no MPI/NCCL/
collectives anywhere); this layer is the genuinely new part.
Design (scaling-book recipe): pick a mesh, annotate shardings, let XLA/GSPMD
insert the collectives, profile.

Two mesh axes map the two embarrassingly-parallel axes of VI:

- ``"mc"``   — the Monte-Carlo sample axis of ``rand(q, n)`` (the reference's
  inner loop, repgradelbo.jl:84-86).  Sharding the (n, d) draw makes every
  per-sample log-density evaluate on its owning device; the mean-reduction in
  the ELBO/gradient becomes a psum (NCCL all-reduce between GPUs).
- ``"data"`` — the minibatch axis of subsampled VI (subsampledobjective.jl):
  per-example log-likelihood terms shard row-wise; their sum is a psum.

Everything else (variational parameters, optimizer state, averager state) is
replicated — it is tiny (O(d) .. O(d^2)).

Determinism: with ``jax_threefry_partitionable`` (on by default in this
package), sharded sampling produces bit-identical draws for ANY device count,
so the estimator is not merely unbiased across mesh shapes — it is pointwise
identical (verified in tests/test_parallel.py).

Multi-host: call ``parallel.distributed.initialize(...)`` before
``make_vi_mesh()``; the same code then runs SPMD across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec

MC_AXIS = "mc"
DATA_AXIS = "data"


def make_vi_mesh(
    n_mc: Optional[int] = None,
    n_data: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Mesh with axes ("data", "mc"); defaults to all devices on "mc".

    The devices are laid out in the order given (``jax.devices()`` by
    default), reshaped to ``(n_data, n_mc)``.  The GPUs of one host are
    joined all to all by NVLink, so no placement of the axes is better than
    another; the mesh follows the algorithm alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_mc is None:
        if n % n_data != 0:
            raise ValueError(
                f"{n} devices not divisible by data axis size {n_data}"
            )
        n_mc = n // n_data
    if n_mc * n_data != n:
        raise ValueError(
            f"mesh ({n_data} x {n_mc}) != device count {n}"
        )
    return Mesh(
        np.asarray(devices).reshape(n_data, n_mc),
        (DATA_AXIS, MC_AXIS),
        axis_types=(AxisType.Auto, AxisType.Auto),
    )


def shard_axis0(x: jax.Array, axis: Optional[str]) -> jax.Array:
    """Constrain axis 0 of ``x`` to shard over mesh axis ``axis``.

    The single annotation point for the MC/data axes: the (n, ...) batch of
    draws or minibatch rows is marked sharded, and GSPMD propagates the
    layout through the per-sample computation and inserts the psum on the
    mean-reductions.  No-op when ``axis`` is None, when no mesh is active,
    or when the active mesh lacks ``axis`` — so objects configured with a
    mesh axis (algorithms, targets, families) still evaluate outside
    ``jax.set_mesh`` (e.g. post-training ``estimate_objective`` on one
    device) instead of crashing on the sharding constraint.
    """
    if axis is None:
        return x
    mesh = jax.sharding.get_abstract_mesh()
    if mesh is None or mesh.empty or axis not in mesh.axis_names:
        return x
    spec = PartitionSpec(axis, *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(x, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def replicate_state(state, mesh: Mesh):
    """Place an algorithm-state pytree fully replicated on the mesh."""
    return jax.device_put(state, replicated(mesh))
