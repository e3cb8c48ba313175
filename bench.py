"""Benchmark: ELBO-gradient steps/s on the flagship logreg model (one GPU).

Workload: mean-field ADVI + sticking-the-landing entropy on the hierarchical
logistic-regression model (reference README.md:27-67; sonar-shaped data
208 x 61), n_samples=10 per gradient, Adam(1e-3) + ClipScale + polynomial
averaging — the reference CI benchmark's configuration family
(bench/benchmarks.jl:56-100) on its flagship model.

Engine: the general path, ``avt.optimize`` with default threefry keys, one
jitted step under the driver's ``lax.scan``.  The first call compiles and is
reported as ``warmup_s``; the timed chunks reuse the compiled program and end
in ``block_until_ready``.

Convergence is reported (``converged``: the ELBO lands near -103 at this
horizon), not asserted.  ``vs_baseline`` is against the documented nominal
proxy REF_STEPS_PER_S for the reference's single-core CPU hot loop on this
workload (the reference publishes no absolute numbers, BASELINE.md).

Fails when the first JAX device is not a GPU.  Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N,
   "device": {"platform", "kind", "count", "card"}, ...}
"""

import json
import math
import os
import sys
import time

import jax
import jax.numpy as jnp

# Documented proxy for the Julia/CPU reference implementation's throughput on
# this workload (no published absolute baseline exists; see BASELINE.md).
REF_STEPS_PER_S = 2000.0

CHUNK = 20_000
N_CHUNKS = 3

BENCH_CONFIG = dict(
    n_data=208, n_features=60, n_samples=10, lr=1e-3, data_seed=11,
)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import optax

    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.logreg import make_logreg
    from advancedvi_jl_tpu.utils.compile_cache import enable_compile_cache
    from chip_smoke import nvidia_smi_lines, require_gpu

    dev = require_gpu()
    card = nvidia_smi_lines().splitlines()[0]
    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    log(f"device: {dev} ({card})")

    cfg = BENCH_CONFIG
    target = make_logreg(
        jax.random.key(cfg["data_seed"]),
        n_data=cfg["n_data"],
        n_features=cfg["n_features"],
    ).unconstrained()
    d = cfg["n_features"] + 2
    q0 = avt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d))
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL,
        n_samples=cfg["n_samples"],
        optimizer=optax.adam(cfg["lr"]),
        operator=avt.ClipScale(),
        averager=avt.PolynomialAveraging(),
    )

    t0 = time.perf_counter()
    _, infos, state = avt.optimize(
        jax.random.key(0), alg, CHUNK, target, q0, log_every=CHUNK
    )
    jax.block_until_ready(state)
    warmup_s = time.perf_counter() - t0
    log(f"warmup (compile + first chunk): {warmup_s:.1f}s")

    times = []
    for _ in range(N_CHUNKS):
        t0 = time.perf_counter()
        _, infos, state = avt.optimize(
            None, alg, CHUNK, target, None, state=state, log_every=CHUNK
        )
        jax.block_until_ready(state)
        times.append(time.perf_counter() - t0)
    elbo = float(infos[-1]["elbo"])
    steps_per_s = CHUNK / min(times)
    log(f"chunks: {[f'{t:.3f}s' for t in times]}  elbo: {elbo:.3f}")

    print(
        json.dumps(
            {
                "metric": "elbo_grad_steps_per_s_logreg_advi_stl",
                "value": steps_per_s,
                "unit": "steps/s",
                "vs_baseline": steps_per_s / REF_STEPS_PER_S,
                "engine": "general_optimize",
                "converged": math.isfinite(elbo) and elbo > -150.0,
                # strict JSON: a non-finite ELBO becomes null
                "elbo": elbo if math.isfinite(elbo) else None,
                "chunk_steps": CHUNK,
                "warmup_s": warmup_s,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                    "card": card,
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
