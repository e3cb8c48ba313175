"""Pathfinder: quasi-Newton variational inference (Zhang et al., JMLR 2022).

Beyond the reference's surface but squarely in its ecosystem (TuringLang
ships Pathfinder.jl alongside AdvancedVI.jl): follow an L-BFGS optimization
trajectory toward the mode, build a Gaussian approximation
N(theta_t, H_t) at EVERY iterate from the accumulated curvature pairs
(H_t = the BFGS inverse-Hessian estimate), score each with a K-sample ELBO,
and return the argmax.  Typically reaches a good posterior approximation in
tens of gradient evaluations — orders of magnitude fewer than SGD-based VI —
which also makes it the natural warm start for ADVI / the measure-space
algorithms.

Design: ONE jitted program. The optimizer loop is a lax.scan over
optax's pure L-BFGS (zoom linesearch included); curvature pairs come from
the collected trajectory (s_t = theta_{t+1}-theta_t, y_t = g_{t+1}-g_t); the
per-iterate inverse Hessian is the dense BFGS recursion over a static
m-window (PSD by construction from H0 = alpha I when s.y > 0, with damped
skipping otherwise), evaluated for ALL T iterates as one vmapped batch of
(d, d) updates + batched Cholesky + batched K-sample ELBOs — batched
small-matrix matmul work, the same shape as the measure-space algorithms.

Multi-path Pathfinder = vmap over jittered starts; draws are pooled with
self-normalized importance weights and checked with the PSIS k-hat
diagnostic (utils/diagnostics.py), as in the paper.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.problem import log_density_and_grad
from ..families.location_scale import FullRankGaussian


class PathfinderResult(NamedTuple):
    q: Any  # FullRankGaussian at the ELBO-argmax iterate
    elbo: jax.Array  # its K-sample ELBO estimate
    best_iter: jax.Array  # trajectory index selected
    elbos: jax.Array  # (T,) per-iterate ELBOs
    trajectory: jax.Array  # (T, d) iterates


def _lbfgs_trajectory(prob, theta0: jax.Array, n_steps: int):
    """(thetas, grads): (T+1, d) iterates of optax L-BFGS on -log pi."""
    import optax

    def neg_logp(theta):
        return -prob.log_density(theta)

    opt = optax.lbfgs()
    value_and_grad = jax.value_and_grad(neg_logp)

    def body(carry, _):
        theta, opt_state = carry
        value, grad = value_and_grad(theta)
        updates, opt_state = opt.update(
            grad, opt_state, theta, value=value, grad=grad,
            value_fn=neg_logp,
        )
        theta_new = optax.apply_updates(theta, updates)
        return (theta_new, opt_state), theta_new

    init = (theta0, opt.init(theta0))
    (_, _), thetas = jax.lax.scan(body, init, None, length=n_steps)
    thetas = jnp.concatenate([theta0[None], thetas], axis=0)  # (T+1, d)
    logps, grads = jax.vmap(lambda th: log_density_and_grad(prob, th))(
        thetas
    )
    return thetas, grads, logps


def _inverse_hessian(s_win: jax.Array, y_win: jax.Array, valid: jax.Array):
    """Dense BFGS inverse-Hessian from an m-window of curvature pairs.

    ``s_win``/``y_win``: (m, d) windows (oldest first); ``valid``: (m,) mask
    (False = padding or a non-curvature pair s.y <= 0, which is skipped —
    the damped/cautious update that keeps H PSD).  H0 = gamma I with the
    standard scaling gamma = (s.y) / (y.y) of the newest valid pair.
    """
    d = s_win.shape[-1]
    sy = jnp.sum(s_win * y_win, axis=-1)  # (m,)
    yy = jnp.sum(y_win * y_win, axis=-1)
    ok = valid & (sy > 1e-12 * jnp.maximum(yy, 1e-30))

    # gamma from the newest usable pair (fall back to 1.0)
    idx = jnp.where(ok, jnp.arange(ok.shape[0]), -1)
    newest = jnp.argmax(idx)
    gamma = jnp.where(
        jnp.any(ok),
        sy[newest] / jnp.maximum(yy[newest], 1e-30),
        1.0,
    )
    H0 = gamma * jnp.eye(d, dtype=s_win.dtype)

    def update(H, inp):
        s, y, use, syi = inp
        rho = 1.0 / jnp.maximum(syi, 1e-30)
        Hy = H @ y
        # BFGS: H' = (I - rho s y^T) H (I - rho y s^T) + rho s s^T
        H_new = (
            H
            - rho * (jnp.outer(s, Hy) + jnp.outer(Hy, s))
            + (rho * rho * jnp.dot(y, Hy) + rho) * jnp.outer(s, s)
        )
        return jnp.where(use, H_new, H), None

    H, _ = jax.lax.scan(update, H0, (s_win, y_win, ok, sy))
    return (H + H.T) / 2.0


def pathfinder(
    key: jax.Array,
    prob,
    theta0: Optional[jax.Array] = None,
    n_steps: int = 30,
    history: int = 6,
    n_elbo_samples: int = 32,
    jitter: float = 2.0,
) -> PathfinderResult:
    """Single-path Pathfinder.  Returns the ELBO-argmax Gaussian.

    ``theta0``: starting point (default: jittered around zero, the paper's
    uniform init analogue).  All work is one jitted program; the gradient
    budget is ``n_steps`` L-BFGS steps (plus linesearch probes).
    """
    from ..core.problem import dim_of, validate_pytree_target

    validate_pytree_target(prob)
    d = dim_of(prob)
    init_key, elbo_key = jax.random.split(key)
    if theta0 is None:
        theta0 = jitter * jax.random.uniform(
            init_key, (d,), minval=-1.0, maxval=1.0
        )

    return _pathfinder_jit(
        prob, theta0, elbo_key, n_steps, history, n_elbo_samples
    )


from functools import partial


@partial(jax.jit, static_argnums=(3, 4, 5))
def _pathfinder_jit(prob, theta0, elbo_key, n_steps, history, n_elbo_samples):
    thetas, grads, logps = _lbfgs_trajectory(prob, theta0, n_steps)
    T = n_steps  # candidate iterates 1..T (index t uses pairs up to t)
    d = theta0.shape[-1]

    s_all = thetas[1:] - thetas[:-1]  # (T, d)
    y_all = grads[:-1] - grads[1:]  # (T, d): y = -(g_{t+1} - g_t) for -logp
    # note: grads are of log pi; BFGS runs on -log pi, whose gradient is -g,
    # so y_t = (-g_{t+1}) - (-g_t) = g_t - g_{t+1} as written.

    def window(t):
        # last `history` pairs ending at t (1-indexed iterates)
        starts = t - history + jnp.arange(history)  # may be negative
        valid = starts >= 0
        idx = jnp.clip(starts, 0, T - 1)
        return s_all[idx], y_all[idx], valid

    def q_at(t):
        s_win, y_win, valid = window(t)
        H = _inverse_hessian(s_win, y_win, valid)
        # Cholesky of the PSD estimate; tiny ridge for f32 robustness.
        C = jnp.linalg.cholesky(H + 1e-8 * jnp.eye(d, dtype=H.dtype))
        return thetas[t + 1], C

    def elbo_at(t, key):
        mu, C = q_at(t)
        bad = jnp.any(jnp.isnan(C))
        C_safe = jnp.where(bad, jnp.eye(d, dtype=C.dtype), C)
        u = jax.random.normal(key, (n_elbo_samples, d), mu.dtype)
        z = u @ C_safe.T + mu
        logq = (
            -0.5 * jnp.sum(jnp.square(u), axis=-1)
            - 0.5 * d * jnp.log(2.0 * jnp.pi)
            - jnp.sum(jnp.log(jnp.abs(jnp.diag(C_safe))))
        )
        logp = jax.vmap(prob.log_density)(z)
        elbo = jnp.mean(logp - logq)
        return jnp.where(bad, -jnp.inf, elbo)

    ts = jnp.arange(T)
    elbos = jax.vmap(elbo_at)(ts, jax.random.split(elbo_key, T))
    elbos = jnp.where(jnp.isfinite(elbos), elbos, -jnp.inf)
    best = jnp.argmax(elbos)
    mu_b, C_b = q_at(best)
    q = FullRankGaussian(mu_b, C_b)
    return PathfinderResult(
        q=q, elbo=elbos[best], best_iter=best + 1, elbos=elbos,
        trajectory=thetas,
    )


def multipath_pathfinder(
    key: jax.Array,
    prob,
    n_paths: int = 8,
    n_draws: int = 1000,
    **kwargs,
):
    """Multi-path Pathfinder: P independent paths from jittered starts,
    draws pooled with self-normalized importance weights over the mixture
    proposal (the paper's PS-IS step), plus the PSIS k-hat diagnostic.

    Returns ``(draws, diagnostics, results)``: (n_draws, d) resampled
    posterior draws, {"khat", "ess"}, and the per-path PathfinderResult
    batch (inspect ``results.elbo`` for path quality).
    """
    import numpy as np

    from ..utils.diagnostics import importance_diagnostics

    keys = jax.random.split(key, n_paths + 2)
    path_keys, draw_key, resample_key = keys[:-2], keys[-2], keys[-1]

    results = [pathfinder(k, prob, **kwargs) for k in path_keys]
    # pool proposal draws from every path's q (equal path weights)
    per_path = max(1, (2 * n_draws) // n_paths)
    zs, logqs = [], []
    for r in results:
        z = r.q.sample(jax.random.fold_in(draw_key, len(zs)), per_path)
        zs.append(z)
        logqs.append(None)
    z_all = jnp.concatenate(zs, axis=0)
    # mixture proposal density over all paths
    logq_mix = jax.nn.logsumexp(
        jnp.stack([r.q.log_prob(z_all) for r in results]), axis=0
    ) - jnp.log(float(n_paths))
    logp = jax.vmap(prob.log_density)(z_all)
    logw = logp - logq_mix

    diag = importance_diagnostics(
        None, None, None, log_weights=np.asarray(jax.device_get(logw))
    )
    # self-normalized importance resampling to n_draws
    wn = jax.nn.softmax(logw)
    idx = jax.random.choice(
        resample_key, z_all.shape[0], (n_draws,), replace=True, p=wn
    )
    return z_all[idx], diag, results
