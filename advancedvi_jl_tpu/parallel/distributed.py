"""Multi-host SPMD launch helpers.

The reference is single-process; this is the multi-host entry point of the
distribution layer (SURVEY.md §2.7).  One process per host, all running the
same program:

    from advancedvi_jl_tpu.parallel import distributed
    distributed.initialize(
        coordinator_address="host0:12345",  # process 0's host, any free port
        num_processes=2,                     # one process per GPU host
        process_id=int(os.environ["RANK"]),  # 0 .. num_processes - 1
    )
    mesh = make_vi_mesh(...)            # spans ALL hosts' devices
    q, info, state = optimize(..., mesh=mesh)

Start the same command on every host, each with its own ``process_id``;
nothing detects the cluster on its own.  After initialization
``jax.devices()`` is global: the same mesh/sharding code that the tests
exercise on a host-simulated 8-device mesh runs unchanged across hosts, with
the "mc"/"data" collectives carried by NCCL.  Gradient/ELBO reductions are
the only cross-device traffic; parameters and optimizer state stay
replicated, so per-step communication is O(samples-reduction), not
O(params).
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX.

    Pass ``coordinator_address="host:port"`` (the host of process 0),
    ``num_processes`` and this process's ``process_id``: a GPU cluster has
    no environment that JAX reads them from.  No-op when already
    initialized.
    """
    # Idempotence via the official query (jax >= 0.4.34) rather than string-
    # matching an error message; fall back to the message match only on jax
    # versions without is_initialized.
    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None and is_init():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if is_init is None and "already" in str(e).lower():
            return
        raise


def is_multi_host() -> bool:
    return jax.process_count() > 1


def sync_hosts(name: str = "avt_barrier") -> None:
    """Cross-host barrier (e.g. before checkpoint writes from process 0)."""
    if not is_multi_host():
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def fully_replicated_host_local(x):
    """Gather a (replicated) device value to every host as a numpy array."""
    import numpy as np

    return np.asarray(jax.device_get(x))
