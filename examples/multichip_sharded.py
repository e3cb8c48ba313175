"""Sharded VI over a device mesh (runs on real chips or a simulated mesh).

Simulated 8-device mesh:
  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/multichip_sharded.py
Multi-host pods: call parallel.distributed.initialize() first (same code).
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu.models.logreg import make_logreg

n_dev = len(jax.devices())
print(f"devices: {n_dev}")
mesh = avt.make_vi_mesh(n_mc=n_dev)  # all devices on the MC-sample axis

target = make_logreg(
    jax.random.key(0), n_data=208, n_features=60, data_axis=None
).unconstrained()
d = target.dim

q0 = avt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d))
alg = avt.KLMinRepGradDescent(
    entropy=avt.STL,
    n_samples=128 * n_dev,  # per-device samples stay constant as you scale
    optimizer=optax.adam(5e-3),
    operator=avt.ClipScale(),
    mc_axis=avt.MC_AXIS,  # shard the (n_samples, d) draw over the mesh
)

q, info, state = avt.optimize(
    jax.random.key(1), alg, 2000, target, q0, mesh=mesh
)
print("final ELBO:", info[-1]["elbo"])
print(
    "Sharded sampling is bit-identical to single-device execution, so this "
    "result does not depend on the device count."
)
