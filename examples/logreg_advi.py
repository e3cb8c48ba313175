"""Flagship example: mean-field ADVI on hierarchical logistic regression.

The reference README's end-to-end example (sigma ~ LogNormal, beta ~
N(0, sigma^2 I), y ~ BernoulliLogit(X beta); sonar-shaped data), in this
framework.  Run (CPU):  JAX_PLATFORMS=cpu python
examples/logreg_advi.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu.models.logreg import make_logreg

model = make_logreg(jax.random.key(0), n_data=208, n_features=60)
target = model.unconstrained()  # Stacked(Identity_61, Exp_1) bijector
d = target.dim

q0 = avt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d))
alg = avt.KLMinRepGradDescent(
    entropy=avt.STL,
    n_samples=10,
    optimizer=optax.adam(5e-3),
    operator=avt.ClipScale(),
)

q, info, state = avt.optimize(
    jax.random.key(1), alg, 5000, target, q0, show_progress=True
)
print("final ELBO:", info[-1]["elbo"])

# Constrained-space posterior: push the optimum through the bijector.
posterior = avt.TransformedDistribution(base=q, transform=target.transform)
draws = posterior.sample(jax.random.key(2), 1000)
sigma_draws = np.asarray(draws[:, -1])
print(f"sigma posterior: mean={sigma_draws.mean():.3f} sd={sigma_draws.std():.3f}")

beta_mean = np.asarray(q.location[:-1])
acc = float(((np.asarray(model.X) @ beta_mean > 0) == (np.asarray(model.y) > 0.5)).mean())
print(f"train accuracy at posterior mean: {acc:.3f}")
