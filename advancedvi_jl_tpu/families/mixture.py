"""Mixture-of-location-scale variational family + stratified ELBO.

Beyond the reference surface (AdvancedVI.jl has no mixture family — SURVEY.md
§2.7 maps expert parallelism to "mixture components if added"): a K-component
mean-field mixture

    q(z) = sum_k w_k N(z; m_k, diag(s_k)^2),   w = softmax(logits)

with the **stratified** ELBO

    ELBO = sum_k w_k E_{z ~ q_k}[log pi(z) - log q(z)]

estimated with n reparameterized draws from EVERY component (a (K, n, d)
batch). Every term is pathwise-differentiable — including the weights, which
appear (a) explicitly in the outer sum and (b) inside log q — so the gradient
is unbiased with no score-function/Gumbel machinery. The sticking-the-landing
variant stops the gradient through log q's parameters; the dropped score term
has zero expectation under the mixture (E_q[∇ log q] = 0), exactly as for the
single-component STL (reference: src/algorithms/entropy.jl STL rationale).

The component axis is the expert-parallel axis: pass ``ep_axis`` to shard the
(K, n, d) stratified batch over a mesh axis — each device evaluates its own
components' energies; GSPMD inserts the reduction.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field, tree_stop_gradient


@pytree_dataclass
class MixtureMeanField:
    """K-component mean-field Gaussian mixture (pytree = parameters)."""

    logits: jax.Array  # (K,)
    locations: jax.Array  # (K, d)
    scale_diags: jax.Array  # (K, d)

    @property
    def dim(self) -> int:
        return self.locations.shape[-1]

    @property
    def n_components(self) -> int:
        return self.locations.shape[0]

    def weights(self) -> jax.Array:
        return jax.nn.softmax(self.logits)

    def sample_stratified(self, key: jax.Array, n_per_component: int):
        """(K, n, d) reparameterized draws, n from each component."""
        K, d = self.locations.shape
        u = jax.random.normal(
            key, (K, n_per_component, d), self.locations.dtype
        )
        return u * self.scale_diags[:, None, :] + self.locations[:, None, :]

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        """Ancestral draws (generation / diagnostics; not the training path)."""
        kc, kz = jax.random.split(key)
        comps = jax.random.categorical(kc, self.logits, shape=(n_samples,))
        u = jax.random.normal(
            kz, (n_samples, self.dim), self.locations.dtype
        )
        return (
            u * self.scale_diags[comps] + self.locations[comps]
        )

    def log_prob(self, z: jax.Array) -> jax.Array:
        """log sum_k w_k N(z; m_k, s_k) via logsumexp; z (..., d)."""
        d = self.dim
        diff = (
            z[..., None, :] - self.locations
        ) / self.scale_diags  # (..., K, d)
        comp_lp = (
            -0.5 * jnp.sum(jnp.square(diff), axis=-1)
            - jnp.sum(jnp.log(jnp.abs(self.scale_diags)), axis=-1)
            - 0.5 * d * math.log(2.0 * math.pi)
        )  # (..., K)
        logw = jax.nn.log_softmax(self.logits)
        return jax.nn.logsumexp(comp_lp + logw, axis=-1)

    def mean(self) -> jax.Array:
        return jnp.einsum("k,kd->d", self.weights(), self.locations)

    def var(self) -> jax.Array:
        w = self.weights()
        m = self.mean()
        second = jnp.einsum(
            "k,kd->d",
            w,
            jnp.square(self.scale_diags) + jnp.square(self.locations),
        )
        return second - jnp.square(m)

    def cov(self) -> jax.Array:
        w = self.weights()
        m = self.mean()
        cov = jnp.einsum(
            "k,kd,ke->de", w, self.locations, self.locations
        ) - jnp.outer(m, m)
        return cov + jnp.diag(
            jnp.einsum("k,kd->d", w, jnp.square(self.scale_diags))
        )


@pytree_dataclass
class MixtureFullRank:
    """K-component full-rank Gaussian mixture; per-component Cholesky scales.

    Like ``FullRankLocationScale``, the strict upper triangle of each
    component's scale is inert (tril-masked at use)."""

    logits: jax.Array  # (K,)
    locations: jax.Array  # (K, d)
    scales: jax.Array  # (K, d, d), lower-triangular by contract

    @property
    def dim(self) -> int:
        return self.locations.shape[-1]

    @property
    def n_components(self) -> int:
        return self.locations.shape[0]

    def weights(self) -> jax.Array:
        return jax.nn.softmax(self.logits)

    def _tril(self) -> jax.Array:
        return jnp.tril(self.scales)

    def sample_stratified(self, key: jax.Array, n_per_component: int):
        K, d = self.locations.shape
        u = jax.random.normal(
            key, (K, n_per_component, d), self.locations.dtype
        )
        # z_k = u_k @ C_k^T + m_k, batched over components (batched matmul)
        return (
            jnp.einsum("knd,ked->kne", u, self._tril())
            + self.locations[:, None, :]
        )

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        kc, kz = jax.random.split(key)
        comps = jax.random.categorical(kc, self.logits, shape=(n_samples,))
        u = jax.random.normal(
            kz, (n_samples, self.dim), self.locations.dtype
        )
        C = self._tril()[comps]  # (n, d, d)
        return jnp.einsum("nd,ned->ne", u, C) + self.locations[comps]

    def log_prob(self, z: jax.Array) -> jax.Array:
        d = self.dim
        C = self._tril()  # (K, d, d)
        diff = z[..., None, :] - self.locations  # (..., K, d)
        # Solve C_k v = diff_k per component (batched triangular solve).
        flat = jnp.moveaxis(diff, -2, 0).reshape(
            self.n_components, -1, d
        )  # (K, N, d)
        v = jax.vmap(
            lambda Ck, Dk: jax.lax.linalg.triangular_solve(
                Ck, Dk.T, left_side=True, lower=True
            ).T
        )(C, flat)  # (K, N, d)
        quad = jnp.sum(jnp.square(v), axis=-1)  # (K, N)
        logdet = jnp.sum(
            jnp.log(jnp.abs(jnp.diagonal(C, axis1=-2, axis2=-1))), axis=-1
        )  # (K,)
        comp_lp = (
            -0.5 * quad
            - logdet[:, None]
            - 0.5 * d * math.log(2.0 * math.pi)
        )  # (K, N)
        logw = jax.nn.log_softmax(self.logits)
        out = jax.nn.logsumexp(comp_lp + logw[:, None], axis=0)  # (N,)
        return out.reshape(diff.shape[:-2])

    def mean(self) -> jax.Array:
        return jnp.einsum("k,kd->d", self.weights(), self.locations)

    def cov(self) -> jax.Array:
        w = self.weights()
        m = self.mean()
        C = self._tril()
        comp_cov = jnp.einsum("kde,kfe->kdf", C, C)  # (K, d, d)
        second = jnp.einsum("k,kdf->df", w, comp_cov) + jnp.einsum(
            "k,kd,ke->de", w, self.locations, self.locations
        )
        return second - jnp.outer(m, m)

    def var(self) -> jax.Array:
        return jnp.diagonal(self.cov())


def mixture_fullrank(
    key: jax.Array,
    dim: int,
    n_components: int,
    init_scale: float = 1.0,
    spread: float = 1.0,
    dtype=jnp.float32,
) -> MixtureFullRank:
    """Fresh full-rank mixture: jittered locations, identity-scaled components."""
    locs = spread * jax.random.normal(key, (n_components, dim), dtype)
    eye = jnp.broadcast_to(
        init_scale * jnp.eye(dim, dtype=dtype), (n_components, dim, dim)
    )
    return MixtureFullRank(
        logits=jnp.zeros(n_components, dtype),
        locations=locs,
        scales=eye,
    )


def mixture_meanfield(
    key: jax.Array,
    dim: int,
    n_components: int,
    init_scale: float = 1.0,
    spread: float = 1.0,
    dtype=jnp.float32,
) -> MixtureMeanField:
    """Fresh mixture: components jittered around the origin, equal weights."""
    locs = spread * jax.random.normal(key, (n_components, dim), dtype)
    return MixtureMeanField(
        logits=jnp.zeros(n_components, dtype),
        locations=locs,
        scale_diags=jnp.full((n_components, dim), init_scale, dtype),
    )


@pytree_dataclass
class MixtureELBO:
    """Stratified-sampling ELBO for mixture families (drop-in ParamSpaceSGD
    objective).

    Args:
      n_samples: reparameterized draws PER COMPONENT per step.
      entropy: "monte_carlo" (log q differentiated) or "stl" (log q's
        parameters stopped — path derivative only; zero-mean dropped term).
      ep_axis: optional mesh axis to shard the component axis over
        (expert parallelism).
    """

    n_samples: int = static_field(default=4)
    entropy: str = static_field(default="stl")
    ep_axis: Optional[str] = static_field(default=None)

    def init(self, key, q, prob):
        return ()

    def loss(self, q, prob, key: jax.Array) -> jax.Array:
        if self.entropy not in ("monte_carlo", "stl"):
            raise ValueError(
                f"unknown mixture entropy estimator: {self.entropy!r} "
                "(supported: 'monte_carlo', 'stl')"
            )
        from ..parallel.mesh import shard_axis0

        z = q.sample_stratified(key, self.n_samples)  # (K, n, d)
        z = shard_axis0(z, self.ep_axis)
        q_for_logq = tree_stop_gradient(q) if self.entropy == "stl" else q
        logq = q_for_logq.log_prob(z)  # (K, n)
        energy = jax.vmap(jax.vmap(prob.log_density))(z)  # (K, n)
        per_comp = jnp.mean(energy - logq, axis=1)  # (K,)
        return -jnp.sum(q.weights() * per_comp)

    def _loss_and_aux(self, q, prob, key: jax.Array):
        from ..core.problem import maybe_wrap_custom_grad

        nelbo = self.loss(q, maybe_wrap_custom_grad(prob), key)
        return nelbo, {"elbo": -nelbo}

    def value_and_grad(self, q, prob, key: jax.Array, obj_state=()):
        (_, info), grad = jax.value_and_grad(
            self._loss_and_aux, has_aux=True
        )(q, prob, key)
        return grad, obj_state, info

    def estimate_objective(
        self, key: jax.Array, q, prob, n_samples: Optional[int] = None
    ) -> jax.Array:
        n = self.n_samples if n_samples is None else n_samples
        obj = MixtureELBO(
            n_samples=n, entropy="monte_carlo", ep_axis=self.ep_axis
        )
        return obj.loss(q, prob, key)
