"""Measure-space (natural-gradient family) algorithms on a Gaussian target.

Run (CPU):  JAX_PLATFORMS=cpu python examples/measure_space_gaussian.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu.models.normal import normal_fullrank

target, mu, L = normal_fullrank(jax.random.key(3), 20)
q0 = avt.FullRankGaussian(jnp.zeros(20))

for name, alg in [
    ("KLMinNaturalGradDescent", avt.KLMinNaturalGradDescent(stepsize=0.1, n_samples=16)),
    ("KLMinSqrtNaturalGradDescent", avt.KLMinSqrtNaturalGradDescent(stepsize=0.05, n_samples=16)),
    ("KLMinWassFwdBwd", avt.KLMinWassFwdBwd(stepsize=0.05, n_samples=16)),
    ("FisherMinBatchMatch", avt.FisherMinBatchMatch(n_samples=64)),
]:
    q, info, _ = avt.optimize(jax.random.key(0), alg, 500, target, q0)
    err = float(jnp.linalg.norm(q.location - mu))
    print(f"{name:28s} elbo={float(info[-1]['elbo']):8.3f}  loc err={err:.4f}")
