"""Measure-space / natural-gradient VI algorithms.

Redesigns of the reference's four measure-space algorithms — each
step is a handful of (d, d) matrix ops compiled into ONE jitted XLA program
(cholesky / triangular-solve via lax.linalg, matrix square roots via a single
symmetric eigendecomposition):

- KLMinNaturalGradDescent  (variational online Newton, precision space;
  reference: src/algorithms/klminnaturalgraddescent.jl:45-191)
- KLMinSqrtNaturalGradDescent  (natural-gradient flow in Cholesky-factor
  parameterization; reference: klminsqrtnaturalgraddescent.jl:39-165)
- KLMinWassFwdBwd  (Wasserstein proximal gradient / JKO forward-backward;
  reference: klminwassfwdbwd.jl:39-160)
- FisherMinBatchMatch  (batch-and-match proximal point for the
  covariance-weighted Fisher divergence; reference: fisherminbatchmatch.jl:40-195)

All are full-rank-Gaussian-only and require a differentiable target, mirroring
the reference's requirements.  The MC expectation over samples is the
shardable axis (parallel/).
"""

from __future__ import annotations

from functools import partial

from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from ..core.problem import subsample as subsample_hook
from ..core.pytree import pytree_dataclass
from ..families.base import Normal
from ..families.location_scale import FullRankLocationScale
from ..objectives.entropy import MONTE_CARLO
from ..objectives.repgradelbo import RepGradELBO
from .gauss_expected import (
    check_capability_at_least_grad,
    gaussian_expected_grad_hess,
)


@pytree_dataclass
class MeasureSpaceState:
    """Shared state: q, target, per-algorithm auxiliary pytree, schedule."""

    q: FullRankLocationScale
    prob: Any
    aux: Any
    iteration: jax.Array
    sub_state: Any
    key: jax.Array


def _symmetrize(A: jax.Array) -> jax.Array:
    return (A + A.T) / 2.0


def _check_q(q, alg_name: str) -> None:
    if not isinstance(q, FullRankLocationScale) or not isinstance(
        q.base, Normal
    ):
        raise ValueError(
            f"{alg_name} requires a FullRankGaussian variational family "
            "(reference requirement)."
        )
    if q.layout != "dense":
        raise ValueError(
            f"{alg_name} rebuilds dense covariance factors each step; "
            "layout='packed' buys nothing there and is not supported — "
            "construct the family with layout='dense'."
        )


class MeasureSpaceAlgorithm:
    """Shared init/step/output skeleton for the four algorithms above.

    ``mc_axis``: optional mesh axis name; the per-step Monte-Carlo draws
    (and their per-sample grad/Hessian evaluations) shard over it exactly
    like RepGradELBO's sample axis (parallel/mesh.py).

    ``hessian``: "auto" (capability dispatch, the reference's behavior),
    "stein" (force the Stein-identity estimator — one matmul + trisolve
    instead of n exact O(d^2) Hessians; the large-d choice), or "exact"
    (see gauss_expected.gaussian_expected_grad_hess).
    """

    name = "MeasureSpaceAlgorithm"

    def __init__(
        self, n_samples=1, subsampling=None, mc_axis=None, hessian="auto"
    ):
        self.n_samples = n_samples
        self.subsampling = subsampling
        self.mc_axis = mc_axis
        self.hessian = hessian

    # per-algorithm hooks -------------------------------------------------
    def _init_aux(self, q: FullRankLocationScale):
        return ()

    def _update(self, q, aux, grad, hess, iteration):
        raise NotImplementedError

    # protocol ------------------------------------------------------------
    def init(self, key: jax.Array, q_init, prob) -> MeasureSpaceState:
        from ..core.problem import validate_pytree_target

        _check_q(q_init, self.name)
        validate_pytree_target(prob)
        check_capability_at_least_grad(prob, self.name)
        sub_key, state_key = jax.random.split(key)
        sub_state = (
            self.subsampling.init(sub_key)
            if self.subsampling is not None
            else ()
        )
        return MeasureSpaceState(
            q=q_init,
            prob=prob,
            aux=self._init_aux(q_init),
            iteration=jnp.asarray(0, jnp.int32),
            sub_state=sub_state,
            key=state_key,
        )

    def _advance_subsampling(self, state: MeasureSpaceState):
        """(prob_for_this_step, new_sub_state, schedule_info)."""
        if self.subsampling is None:
            return state.prob, state.sub_state, {}
        batch, sub_state, sub_info = self.subsampling.step(state.sub_state)
        return subsample_hook(state.prob, batch), sub_state, sub_info

    def step(self, state: MeasureSpaceState):
        it = state.iteration + 1
        step_key = jax.random.fold_in(state.key, state.iteration)

        prob_sub, sub_state, info = self._advance_subsampling(state)
        info = dict(info)

        logpi_avg, grad, hess = gaussian_expected_grad_hess(
            step_key, state.q, self.n_samples, prob_sub,
            mc_axis=self.mc_axis, hessian=self.hessian,
        )
        q_new, aux_new, extra_info = self._update(
            state.q, state.aux, grad, hess, it
        )

        # All shared-skeleton algorithms log elbo = E[log pi] + H(q')
        # (BaM overrides step() and logs H(q) itself, matching the reference).
        info["elbo"] = logpi_avg + q_new.entropy()
        info.update(extra_info)
        info["diverged"] = ~jnp.isfinite(info["elbo"])

        new_state = MeasureSpaceState(
            q=q_new,
            prob=state.prob,
            aux=aux_new,
            iteration=it,
            sub_state=sub_state,
            key=state.key,
        )
        return new_state, info

    def output(self, state: MeasureSpaceState):
        return state.q

    def estimate_objective(
        self,
        key: jax.Array,
        q,
        prob,
        n_samples: Optional[int] = None,
        entropy: str = MONTE_CARLO,
    ):
        """neg-ELBO via RepGrad + MC entropy; full-epoch sweep under
        subsampling (reference: klminnaturalgraddescent.jl:172-191).
        ``entropy`` overrides the evaluation entropy estimator, mirroring the
        reference's kwarg (common.jl:29-38)."""
        n = n_samples if n_samples is not None else self.n_samples
        obj = RepGradELBO(n_samples=n, entropy=entropy, mc_axis=self.mc_axis)
        if self.subsampling is None:
            return obj.estimate_objective(key, q, prob)
        from ..objectives.subsampled import SubsampledObjective

        return SubsampledObjective(
            objective=obj, subsampling=self.subsampling
        ).estimate_objective(key, q, prob)


class KLMinNaturalGradDescent(MeasureSpaceAlgorithm):
    """Variational online Newton in precision space (Khan & Lin 2017).

    S' = S - eta (S + H) [+ eta^2/2 G Sigma G posdef correction, Lin et al.
    ICML 2020];  m' = m + eta S'^-1 g
    (reference: klminnaturalgraddescent.jl:95-153).
    """

    name = "KLMinNaturalGradDescent"

    def __init__(
        self,
        stepsize: float,
        n_samples: int = 1,
        ensure_posdef: bool = True,
        subsampling=None,
        mc_axis=None,
        hessian: str = "auto",
    ):
        super().__init__(
            n_samples=n_samples, subsampling=subsampling, mc_axis=mc_axis,
            hessian=hessian,
        )
        self.stepsize = stepsize
        self.ensure_posdef = ensure_posdef

    def _init_aux(self, q):
        # Cache the precision S = C^-T C^-1 (reference: :72-90).
        C = q.tril_scale()
        Cinv = jax.scipy.linalg.solve_triangular(
            C, jnp.eye(C.shape[0], dtype=C.dtype), lower=True
        )
        prec = _symmetrize(Cinv.T @ Cinv)
        return prec

    def _update(self, q, prec, grad, hess, iteration):
        eta = jnp.asarray(self.stepsize, q.location.dtype)
        S = prec
        if self.ensure_posdef:
            # Posdef-guaranteed rule (Lin et al. 2020, reference :124-133):
            # G_hat = S - (-H);  S' = S - eta G_hat + eta^2/2 G_hat Sigma G_hat
            qcov = q.cov()
            G_hat = S + hess
            S_new = _symmetrize(
                S - eta * G_hat + (eta * eta / 2.0) * (G_hat @ qcov @ G_hat)
            )
        else:
            S_new = _symmetrize((1.0 - eta) * S - eta * hess)
        # m' = m - eta S'^-1 (-g)
        chol = cho_factor(S_new, lower=True)
        m_new = q.location + eta * cho_solve(chol, grad)
        # New scale: lower-triangular factor of Sigma' = S'^-1.
        sigma_new = cho_solve(chol, jnp.eye(S_new.shape[0], dtype=S_new.dtype))
        scale_new = jnp.linalg.cholesky(_symmetrize(sigma_new))
        q_new = q.replace(location=m_new, scale=scale_new)
        return q_new, S_new, {}


class KLMinSqrtNaturalGradDescent(MeasureSpaceAlgorithm):
    """Natural-gradient flow in square-root (Cholesky) parameterization.

    C' = C - eta C tril_half(C^T (-H) C - I), where tril_half keeps the lower
    triangle with the diagonal halved; m' = m + eta C C^T g
    (reference: klminsqrtnaturalgraddescent.jl:79-127).  No per-step cholesky.
    """

    name = "KLMinSqrtNaturalGradDescent"

    def __init__(
        self,
        stepsize: float,
        n_samples: int = 1,
        subsampling=None,
        mc_axis=None,
        hessian: str = "auto",
    ):
        super().__init__(
            n_samples=n_samples, subsampling=subsampling, mc_axis=mc_axis,
            hessian=hessian,
        )
        self.stepsize = stepsize

    def _update(self, q, aux, grad, hess, iteration):
        eta = jnp.asarray(self.stepsize, q.location.dtype)
        C = q.tril_scale()
        M = C.T @ (-hess) @ C - jnp.eye(C.shape[0], dtype=C.dtype)
        M_tril = jnp.tril(M) - jnp.diag(jnp.diag(M)) / 2.0
        m_new = q.location + eta * (C @ (C.T @ grad))
        C_new = C - eta * (C @ M_tril)
        return q.replace(location=m_new, scale=C_new), aux, {}


class KLMinWassFwdBwd(MeasureSpaceAlgorithm):
    """Wasserstein proximal gradient (JKO forward-backward, Diao et al. 2023).

    Forward: m' = m + eta g;  M = I + eta H^T;  Sigma_half = M Sigma M^T.
    Backward (JKO prox, closed form):
      Sigma' = (Sigma_half + 2 eta I + sqrtm(Sigma_half (Sigma_half+4 eta I)))/2
    (reference: klminwassfwdbwd.jl:80-122).

    Sigma_half and Sigma_half + 4 eta I commute, so the prox is a
    SINGLE symmetric eigendecomposition with the eigenvalue map
    lam' = (lam + 2 eta + sqrt(lam (lam + 4 eta)))/2 — no general sqrtm
    needed.  ``sqrtm="newton_schulz"`` replaces the eigh with
    the matmul-only Newton-Schulz iteration for
    sqrtm(Sigma_half^2 + 4 eta Sigma_half) — matmuls only; the +2 eta I
    term keeps the prox eigenvalues >= eta, so the iteration's small
    approximation error cannot break positive-definiteness.
    """

    name = "KLMinWassFwdBwd"

    def __init__(
        self,
        stepsize: float,
        n_samples: int = 1,
        subsampling=None,
        sqrtm: str = "eigh",
        sqrtm_iters: int = 20,
        mc_axis=None,
        hessian: str = "auto",
    ):
        super().__init__(
            n_samples=n_samples, subsampling=subsampling, mc_axis=mc_axis,
            hessian=hessian,
        )
        self.stepsize = stepsize
        if sqrtm not in ("eigh", "newton_schulz"):
            raise ValueError(
                f"sqrtm must be 'eigh' or 'newton_schulz', got {sqrtm!r}"
            )
        self.sqrtm = sqrtm
        # Newton–Schulz iteration count: the default 20 is ample for
        # well-conditioned sigma; raise it for spectra spanning >~1e4 (the
        # near-zero eigenvalues converge linearly until the quadratic phase).
        self.sqrtm_iters = sqrtm_iters

    def _init_aux(self, q):
        return q.cov()

    def _update(self, q, sigma, grad, hess, iteration):
        eta = jnp.asarray(self.stepsize, q.location.dtype)
        d = q.dim
        m_new = q.location + eta * grad
        M = jnp.eye(d, dtype=sigma.dtype) + eta * hess.T
        sigma_half = _symmetrize(M @ sigma @ M.T)
        if self.sqrtm == "newton_schulz":
            from ..ops.sqrtm import sqrtm_newton_schulz

            S = sqrtm_newton_schulz(
                _symmetrize(sigma_half @ sigma_half + 4.0 * eta * sigma_half),
                n_iter=self.sqrtm_iters,
            )
            sigma_new = _symmetrize(
                (sigma_half + 2.0 * eta * jnp.eye(d, dtype=sigma.dtype) + S)
                / 2.0
            )
        else:
            lam, V = jnp.linalg.eigh(sigma_half)
            lam = jnp.maximum(lam, 0.0)
            lam_new = (
                lam + 2.0 * eta + jnp.sqrt(lam * (lam + 4.0 * eta))
            ) / 2.0
            sigma_new = _symmetrize((V * lam_new) @ V.T)
        scale_new = jnp.linalg.cholesky(sigma_new)
        q_new = q.replace(location=m_new, scale=scale_new)
        return q_new, sigma_new, {}


class FisherMinBatchMatch(MeasureSpaceAlgorithm):
    """Batch-and-match: proximal point for covariance-weighted Fisher divergence.

    Moment-matching update with schedule lam_t = d * n / t
    (reference: fisherminbatchmatch.jl:40-195).  The backward map
    Sigma' = 2 V (I + sqrt(I + 4 U V))^-1 is evaluated in **factored form**:
    for ANY factor V = F F^T,

        Sigma' = 2 F (I + sqrt(I + 4 F^T U F))^-1 F^T

    (verified by the defining equation Sigma' U Sigma' + Sigma' = V: with
    T = F^T U F, S = sqrt(I + 4T), M = 2(I+S)^-1, one checks M T M + M = I).
    Both U and the increment of V are rank-(n+1) by construction
    (U = G G^T from the score moments, V = C C^T + E E^T from the sample
    moments), so every matrix function reduces to a thin SVD of a (d, n+1)
    matrix — identity-plus-low-rank corrections whose null directions are
    EXACT. The naive dense form (W = sqrtm(V), sqrt(I + 4 W U W)) forms
    intermediates of magnitude lam^2 ~ (d n / t)^2 early on, and float32
    eigh error (eps * ||M||) destroys the O(1) eigenvalues of exactly the
    sample-starved directions — measured: sigma's min eigenvalue collapsed
    ~10x per step at d=256, n=32 until cholesky produced NaN. The factored
    form is also cheaper: two (d, n+1) SVDs + one cholesky instead of two
    (d, d) eighs + cholesky.
    """

    name = "FisherMinBatchMatch"

    def __init__(self, n_samples: int = 32, subsampling=None, mc_axis=None):
        if n_samples < 2:
            raise ValueError(
                "FisherMinBatchMatch needs n_samples >= 2: its update uses "
                "CENTERED sample moments (the lam/(n-1) weighting divides by "
                f"zero for n_samples={n_samples})."
            )
        super().__init__(
            n_samples=n_samples, subsampling=subsampling, mc_axis=mc_axis
        )

    def step(self, state: MeasureSpaceState):
        # BaM draws its own (u, z) pairs and needs per-sample gradients, so it
        # overrides the shared grad/hess skeleton
        # (reference: rand_batch_match_samples_with_objective!, :101-129).
        it = state.iteration + 1
        step_key = jax.random.fold_in(state.key, state.iteration)
        q = state.q
        n = self.n_samples
        d = q.dim

        prob_sub, sub_state, info = self._advance_subsampling(state)
        info = dict(info)

        from ..parallel.mesh import shard_axis0

        # Every product of the update runs at full float32 precision: the
        # batch-size schedule lam = d n / t amplifies rounding in the draw
        # and in the factors by up to lam (d n at step 1), and at a GPU's
        # default TF32 matmuls the updated location moved ~10% off the
        # float32 result at d=256, n=32 (PERF.md, bring-up findings).
        mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
        mu = q.location
        C = q.tril_scale()  # cholesky factor of the current sigma
        u = shard_axis0(q.base.sample(step_key, (n, d), mu.dtype), self.mc_axis)
        z = shard_axis0(mm(u, C.T) + mu, self.mc_axis)

        from ..core.problem import log_density_and_grad

        logpi, grads = jax.vmap(
            lambda zz: log_density_and_grad(prob_sub, zz)
        )(z)
        logpi_avg = jnp.mean(logpi)
        # F = E || -u - C^T grad ||^2 (reference derivation :101-110)
        fisher = jnp.sum(jnp.square(-u - mm(grads, C))) / n

        zbar = jnp.mean(z, axis=0)
        gbar = jnp.mean(grads, axis=0)
        zc = z - zbar
        gc = grads - gbar

        lam = jnp.asarray(d * n, mu.dtype) / it.astype(mu.dtype)
        w = lam / (1.0 + lam)
        mumz = mu - zbar

        # U = G G^T,  V = sigma + E E^T = C C^T + E E^T   (rank-(n+1) factors)
        sl = jnp.sqrt(lam / (n - 1))
        G = jnp.concatenate(
            [sl * gc, jnp.sqrt(w) * gbar[None, :]], axis=0
        ).T  # (d, n+1)
        E = jnp.concatenate(
            [sl * zc, jnp.sqrt(w) * mumz[None, :]], axis=0
        ).T  # (d, n+1)

        # Factor F with V = F F^T: F = C (I + P1 (sqrt(1+s1^2)-1) P1^T)
        # where C^-1 E = P1 diag(s1) Q1^T (thin SVD).
        Et = jax.lax.linalg.triangular_solve(
            C, E, left_side=True, lower=True
        )  # C^-1 E, (d, k)
        P1, s1, _ = jnp.linalg.svd(Et, full_matrices=False)
        F = C + mm(mm(C, P1) * (jnp.sqrt(1.0 + jnp.square(s1)) - 1.0), P1.T)

        # M^{1/2} with M = 2 (I + sqrt(I + 4 F^T U F))^-1:
        # F^T G = P2 diag(s2) Q2^T  =>  sqrt(I + 4 T) = I + P2 (r2 - 1) P2^T,
        # M^{1/2} = I - P2 (1 - sqrt(2/(1+r2))) P2^T,  r2 = sqrt(1 + 4 s2^2).
        B = mm(F.T, G)  # (d, k)
        P2, s2, _ = jnp.linalg.svd(B, full_matrices=False)
        r2 = jnp.sqrt(1.0 + 4.0 * jnp.square(s2))
        F_new = F - mm(mm(F, P2) * (1.0 - jnp.sqrt(2.0 / (1.0 + r2))), P2.T)

        # sigma_new = F_new F_new^T, applied as an operator for the mean step
        mu_new = (
            mu + lam * (mm(F_new, mm(F_new.T, gbar)) + zbar)
        ) / (1.0 + lam)

        scale_new = jnp.linalg.cholesky(_symmetrize(mm(F_new, F_new.T)))
        q_new = q.replace(location=mu_new, scale=scale_new)

        # BaM logs the entropy of the *pre-update* q (reference :157).
        info["elbo"] = logpi_avg + q.entropy()
        info["covweighted_fisher"] = fisher
        info["diverged"] = ~jnp.isfinite(info["elbo"])

        new_state = MeasureSpaceState(
            q=q_new,
            prob=state.prob,
            aux=state.aux,
            iteration=it,
            sub_state=sub_state,
            key=state.key,
        )
        return new_state, info

    def estimate_objective(
        self, key: jax.Array, q, prob, n_samples: Optional[int] = None
    ):
        """Covariance-weighted Fisher divergence estimate
        (reference: fisherminbatchmatch.jl:186-195)."""
        from ..parallel.mesh import shard_axis0

        n = n_samples if n_samples is not None else self.n_samples
        mu = q.location
        C = q.tril_scale()
        u = shard_axis0(q.base.sample(key, (n, q.dim), mu.dtype), self.mc_axis)
        z = shard_axis0(u @ C.T + mu, self.mc_axis)
        from ..core.problem import log_density_and_grad

        _, grads = jax.vmap(lambda zz: log_density_and_grad(prob, zz))(z)
        return jnp.sum(jnp.square(-u - grads @ C)) / n
