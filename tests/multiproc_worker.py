"""Worker for the multi-process SPMD test (not a pytest module).

Launched N times by tests/test_multiprocess.py with
``python multiproc_worker.py <pid> <nproc> <port> <outdir>``.  Each process
owns 4 virtual CPU devices; together they form the 8-device global mesh the
single-process tests use, so results must match those bitwise-ish
(threefry_partitionable draws are identical for identical global mesh shape).

Exercises the full multi-host story (SURVEY.md §2.7 collectives row):
jax.distributed bring-up through parallel.distributed.initialize, a global
mesh spanning both processes, GSPMD collectives between the processes,
sync_hosts barrier, and process-0-only checkpoint writes.
"""

import json
import os
import sys


def main() -> None:
    pid, nproc, port, outdir = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        sys.argv[3],
        sys.argv[4],
    )
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)

    from advancedvi_jl_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    # Idempotence: a second call must be a clean no-op.
    distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert distributed.is_multi_host()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    import jax.numpy as jnp
    import numpy as np

    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.normal import normal_fullrank
    from advancedvi_jl_tpu.parallel.mesh import MC_AXIS, make_vi_mesh

    target, mu, L = normal_fullrank(jax.random.key(3), 5)
    q0 = avt.FullRankGaussian(jnp.zeros(5))
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=16, operator=avt.ClipScale(),
        mc_axis=MC_AXIS,
    )
    mesh = make_vi_mesh(n_mc=4 * nproc)  # spans BOTH processes' devices
    out, infos, state = avt.optimize(
        jax.random.key(0), alg, 100, target, q0, mesh=mesh
    )

    loc = distributed.fully_replicated_host_local(out.location)
    scale = distributed.fully_replicated_host_local(jnp.tril(out.scale))
    elbo = float(infos[-1]["elbo"])
    assert np.all(np.isfinite(loc)) and np.isfinite(elbo)

    # Barrier, then checkpoint from process 0 ONLY (the multi-host
    # checkpointing contract: everyone syncs, one host writes).
    distributed.sync_hosts("pre_checkpoint")
    if jax.process_index() == 0:
        from advancedvi_jl_tpu.utils.checkpoint import save_state

        save_state(os.path.join(outdir, "ckpt.npz"), state)
    distributed.sync_hosts("post_checkpoint")

    with open(os.path.join(outdir, f"result_{pid}.json"), "w") as f:
        json.dump(
            {"loc": loc.tolist(), "scale": scale.tolist(), "elbo": elbo}, f
        )
    print(f"[worker {pid}] OK elbo={elbo}", flush=True)


if __name__ == "__main__":
    main()
