"""Example: write a model with the built-in PPL DSL and fit it three ways.

Hierarchical logistic regression (the reference's README model), authored as
a probabilistic program instead of a hand-written log-density:

    sigma ~ LogNormal(0, 3)
    beta  ~ Normal(0, sigma^2 I)
    y_i   ~ BernoulliLogit(x_i . beta)        [subsampled plate]

Run (CPU):  JAX_PLATFORMS=cpu python examples/ppl_model.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu import ppl

N, D = 208, 20
k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
X = jax.random.normal(k1, (N, D))
beta_true = jax.random.normal(k2, (D,))
y = (jax.random.uniform(k3, (N,)) < jax.nn.sigmoid(X @ beta_true)).astype(
    jnp.float32
)


def model(data):
    sigma = ppl.sample("sigma", ppl.LogNormal(0.0, 3.0))
    beta = ppl.sample("beta", ppl.Normal(jnp.zeros(D), sigma))
    logits = data["X"] @ beta
    with ppl.plate("obs", N):
        ppl.sample("y", ppl.Bernoulli(logits=logits), obs=data["y"])


m = ppl.ingest(model, data={"X": X, "y": y})
print(f"ingested: dim={m.dim} latents={list(m.latents)}")

# 1. Full-batch ADVI
alg = avt.KLMinRepGradDescent(
    entropy=avt.STL, n_samples=16, optimizer=optax.adam(2e-2),
    operator=avt.ClipScale(),
)
q, infos, _ = avt.optimize(jax.random.key(1), alg, 3000, m.target, m.q_init())
print(f"[full-batch ADVI]  elbo={infos[-1]['elbo']:.2f}")

# 2. Doubly-stochastic (minibatch 32) — plate-observed sites auto-rescale
alg_sub = avt.KLMinRepGradDescent(
    entropy=avt.STL, n_samples=16, optimizer=optax.adam(2e-2),
    operator=avt.ClipScale(),
    subsampling=avt.ReshufflingBatchSubsampling(n_data=N, batchsize=32),
)
q_sub, infos_sub, _ = avt.optimize(
    jax.random.key(1), alg_sub, 3000, m.target, m.q_init(), log_every=100
)
print(f"[subsampled ADVI]  elbo={infos_sub[-1]['elbo']:.2f} "
      f"epochs={infos_sub[-1]['epoch']}")

# 3. Natural-gradient descent on the same ingested target (full-rank family)
ngd = avt.KLMinNaturalGradDescent(stepsize=0.05, n_samples=16)
q_ngd, infos_ngd, _ = avt.optimize(
    jax.random.key(1), ngd, 1500, m.target,
    avt.FullRankGaussian(jnp.zeros(m.dim), 0.1 * jnp.eye(m.dim)),
)
print(f"[NGD]              elbo={infos_ngd[-1]['elbo']:.2f}")

# Posterior draws in CONSTRAINED space, per site
post = m.sample_posterior(jax.random.key(2), q, 2000)
beta_err = float(jnp.linalg.norm(jnp.mean(post["beta"], 0) - beta_true))
print(f"posterior: sigma mean={float(jnp.mean(post['sigma'])):.3f}, "
      f"|E[beta] - beta_true|={beta_err:.3f}")
