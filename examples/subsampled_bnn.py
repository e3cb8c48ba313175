"""Doubly-stochastic VI on a Bayesian MLP posterior with minibatching.

Run (CPU):  JAX_PLATFORMS=cpu python examples/subsampled_bnn.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu.models.bnn import make_bnn

bnn = make_bnn(jax.random.key(0), n_data=2048, in_dim=8, hidden=32)
bnn = bnn.replace(noise_scale=0.25)
d = bnn.dim
print(f"BNN posterior dimension: {d}")

q0 = avt.MeanFieldGaussian(jnp.zeros(d), 0.05 * jnp.ones(d))
sub = avt.ReshufflingBatchSubsampling(n_data=2048, batchsize=256)
alg = avt.KLMinRepGradDescent(
    entropy=avt.STL,
    n_samples=8,
    subsampling=sub,  # likelihood rescaled by n/batch automatically
    optimizer=optax.adam(3e-3),
    operator=avt.ClipScale(),
)

q, info, state = avt.optimize(jax.random.key(1), alg, 8000, bnn, q0)
print("final ELBO:", info[-1]["elbo"], " epochs:", info[-1]["epoch"])

pred = np.asarray(bnn.forward(q.location, bnn.X))
corr = np.corrcoef(pred, np.asarray(bnn.y))[0, 1]
print(f"posterior-mean prediction correlation: {corr:.3f}")

# Checkpoint, restore, continue — bitwise identical to not stopping.
avt.save_state("/tmp/bnn_ckpt", state)
restored = avt.restore_state("/tmp/bnn_ckpt", alg.init(jax.random.key(1), q0, bnn))
q2, info2, _ = avt.optimize(jax.random.key(1), alg, 1000, bnn, q0, state=restored)
pred2 = np.asarray(bnn.forward(q2.location, bnn.X))
corr2 = np.corrcoef(pred2, np.asarray(bnn.y))[0, 1]
print(f"after resume (+1000 iters): ELBO {info2[-1]['elbo']:.1f}, correlation {corr2:.3f}")
