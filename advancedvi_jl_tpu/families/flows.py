"""Normalizing-flow variational families.

The reference's docs point users at NormalizingFlows.jl for flow-based q's;
its objectives only require ``rand`` + ``logpdf``.  Here the equivalent
contract is ``sample_and_log_prob`` (reparameterized draws together with
their log-density accumulated through the flow), consumed by ``FlowELBO`` —
the Monte-Carlo-entropy ELBO, which is the standard flow objective.

Demonstrated with planar flows (Rezende & Mohamed 2015):

    z = f_K(...f_1(u)),  f(z) = z + a_hat * tanh(w . z + b),  u ~ N(m0, S0)

with the invertibility reparameterization a_hat = a + (softplus(w.a) - 1 -
w.a) w / ||w||^2 (guarantees w . a_hat >= -1).  Sticking-the-landing entropy
is intentionally NOT offered here: it requires evaluating the frozen density
at live samples, i.e. an analytic flow inverse, which planar flows lack.

Every layer update is a (n, d) elementwise block plus one (n, d) x (d,)
contraction — the scan over layers stays on-device and fuses well.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field


@pytree_dataclass
class PlanarFlowFamily:
    """Mean-field Gaussian base pushed through K planar-flow layers."""

    base_location: jax.Array  # (d,)
    base_scale_diag: jax.Array  # (d,)
    w: jax.Array  # (K, d)
    a: jax.Array  # (K, d)
    b: jax.Array  # (K,)

    @property
    def dim(self) -> int:
        return self.base_location.shape[-1]

    @property
    def n_layers(self) -> int:
        return self.w.shape[0]

    def _a_hat(self, w, a):
        wa = jnp.dot(w, a)
        m = jax.nn.softplus(wa) - 1.0
        return a + (m - wa) * w / (jnp.sum(jnp.square(w)) + 1e-12)

    def sample_and_log_prob(self, key: jax.Array, n_samples: int):
        """Reparameterized samples and their log-density under q."""
        d = self.dim
        u = jax.random.normal(key, (n_samples, d), self.base_location.dtype)
        z = u * self.base_scale_diag + self.base_location
        logq = (
            jnp.sum(-0.5 * jnp.square(u), axis=-1)
            - 0.5 * d * math.log(2.0 * math.pi)
            - jnp.sum(jnp.log(jnp.abs(self.base_scale_diag)))
        )

        def layer(carry, params):
            z, logq = carry
            w, a, b = params
            a_hat = self._a_hat(w, a)
            lin = z @ w + b  # (n,)
            z_new = z + jnp.tanh(lin)[:, None] * a_hat
            # |det J| = |1 + (1 - tanh^2(lin)) w . a_hat|
            psi = 1.0 - jnp.square(jnp.tanh(lin))
            det = 1.0 + psi * jnp.dot(w, a_hat)
            logq = logq - jnp.log(jnp.abs(det) + 1e-12)
            return (z_new, logq), None

        (z, logq), _ = jax.lax.scan(layer, (z, logq), (self.w, self.a, self.b))
        return z, logq

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        return self.sample_and_log_prob(key, n_samples)[0]


def planar_flow(
    key: jax.Array, dim: int, n_layers: int = 8, dtype=jnp.float32
) -> PlanarFlowFamily:
    """Fresh near-identity planar-flow family."""
    kw, ka = jax.random.split(key)
    return PlanarFlowFamily(
        base_location=jnp.zeros(dim, dtype),
        base_scale_diag=jnp.ones(dim, dtype),
        w=0.1 * jax.random.normal(kw, (n_layers, dim), dtype),
        a=0.1 * jax.random.normal(ka, (n_layers, dim), dtype),
        b=jnp.zeros(n_layers, dtype),
    )


@pytree_dataclass
class RadialFlowFamily:
    """Mean-field Gaussian base pushed through K radial-flow layers
    (Rezende & Mohamed 2015, the reference tutorial's other flow):

        f(z) = z + beta_hat * h(alpha, r) * (z - z0),   r = ||z - z0||,
        h = 1 / (alpha + r)

    with alpha = softplus(alpha_raw) > 0 and the invertibility
    reparameterization beta_hat = -alpha + softplus(beta_raw) >= -alpha.
    log|det J| = (d-1) log(1 + beta_hat h) + log(1 + beta_hat h - beta_hat
    r / (alpha + r)^2)."""

    base_location: jax.Array  # (d,)
    base_scale_diag: jax.Array  # (d,)
    z0: jax.Array  # (K, d)
    alpha_raw: jax.Array  # (K,)
    beta_raw: jax.Array  # (K,)

    @property
    def dim(self) -> int:
        return self.base_location.shape[-1]

    @property
    def n_layers(self) -> int:
        return self.z0.shape[0]

    def sample_and_log_prob(self, key: jax.Array, n_samples: int):
        d = self.dim
        u = jax.random.normal(key, (n_samples, d), self.base_location.dtype)
        z = u * self.base_scale_diag + self.base_location
        logq = (
            jnp.sum(-0.5 * jnp.square(u), axis=-1)
            - 0.5 * d * math.log(2.0 * math.pi)
            - jnp.sum(jnp.log(jnp.abs(self.base_scale_diag)))
        )

        def layer(carry, params):
            z, logq = carry
            z0, alpha_raw, beta_raw = params
            alpha = jax.nn.softplus(alpha_raw)
            beta = -alpha + jax.nn.softplus(beta_raw)
            diff = z - z0  # (n, d)
            r = jnp.sqrt(jnp.sum(jnp.square(diff), axis=-1) + 1e-12)  # (n,)
            h = 1.0 / (alpha + r)
            z_new = z + (beta * h)[:, None] * diff
            bh = beta * h
            # d/dr of h(r) = -1/(alpha+r)^2, so the radial eigenvalue is
            # 1 + beta h + beta h'(r) r = 1 + beta h - beta r/(alpha+r)^2
            radial = 1.0 + bh - beta * r / jnp.square(alpha + r)
            logdet = (d - 1) * jnp.log(jnp.abs(1.0 + bh) + 1e-12) + jnp.log(
                jnp.abs(radial) + 1e-12
            )
            return (z_new, logq - logdet), None

        (z, logq), _ = jax.lax.scan(
            layer, (z, logq), (self.z0, self.alpha_raw, self.beta_raw)
        )
        return z, logq

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        return self.sample_and_log_prob(key, n_samples)[0]


def radial_flow(
    key: jax.Array, dim: int, n_layers: int = 8, dtype=jnp.float32
) -> RadialFlowFamily:
    """Fresh near-identity radial-flow family (beta ~ 0 at init)."""
    kz = key
    return RadialFlowFamily(
        base_location=jnp.zeros(dim, dtype),
        base_scale_diag=jnp.ones(dim, dtype),
        z0=0.1 * jax.random.normal(kz, (n_layers, dim), dtype),
        # softplus(1.0) ~ 1.31 => alpha ~ 1.31; beta_hat = -alpha +
        # softplus(beta_raw) ~ 0 when softplus(beta_raw) ~ alpha
        alpha_raw=jnp.full((n_layers,), 1.0, dtype),
        beta_raw=jnp.full((n_layers,), 1.0, dtype),
    )


@pytree_dataclass
class CouplingFlowFamily:
    """RealNVP-style affine-coupling flow with an ANALYTIC inverse.

    Each of the K layers transforms the complement of an alternating
    checkerboard mask m_k (m_k[i] = (i + k) % 2):

        y = m*z + (1-m) * (z * exp(s(m*z)) + t(m*z))

    with (s, t) produced by a small per-layer MLP conditioner reading only
    the masked coordinates; log|det J| = sum((1-m) * s).  The inverse is
    closed form — ``z = m*y + (1-m) * (y - t(m*y)) * exp(-s(m*y))`` — so,
    unlike planar/radial flows, the density is available at ARBITRARY
    points: ``log_prob`` exists and the sticking-the-landing entropy
    estimator applies (``FlowELBO(entropy="stl")``), exceeding the
    reference's flow-tutorial surface (reference README.md:91-120 pattern,
    which only needs rand + logpdf along the sampling path).

    s is tanh-bounded (|s| <= s_cap) so both directions stay float32-stable;
    conditioner output weights init to zero -> the flow starts at identity.
    Every layer is one (n, d) x (d, h) + (n, h) x (h, 2d) matmul pair —
    Matmul work batched over samples, scanned over layers on-device.
    """

    base_location: jax.Array  # (d,)
    base_scale_diag: jax.Array  # (d,)
    W1: jax.Array  # (K, d, h)
    b1: jax.Array  # (K, h)
    W2: jax.Array  # (K, h, 2d)
    b2: jax.Array  # (K, 2d)
    s_cap: float = static_field(default=2.0)

    @property
    def dim(self) -> int:
        return self.base_location.shape[-1]

    @property
    def n_layers(self) -> int:
        return self.W1.shape[0]

    def _mask(self, k) -> jax.Array:
        d = self.dim
        return ((jnp.arange(d) + k) % 2).astype(self.base_location.dtype)

    def _st(self, z_masked, params):
        W1, b1, W2, b2 = params
        h = jnp.tanh(z_masked @ W1 + b1)
        st = h @ W2 + b2
        s_raw, t = st[..., : self.dim], st[..., self.dim :]
        return self.s_cap * jnp.tanh(s_raw / self.s_cap), t

    def _layer_params(self):
        return (
            jnp.arange(self.n_layers),
            (self.W1, self.b1, self.W2, self.b2),
        )

    def _base_log_prob(self, u: jax.Array) -> jax.Array:
        d = self.dim
        return (
            jnp.sum(-0.5 * jnp.square(u), axis=-1)
            - 0.5 * d * math.log(2.0 * math.pi)
            - jnp.sum(jnp.log(jnp.abs(self.base_scale_diag)))
        )

    def sample_and_log_prob(self, key: jax.Array, n_samples: int):
        """Reparameterized samples with the density along the sampling path."""
        u = jax.random.normal(
            key, (n_samples, self.dim), self.base_location.dtype
        )
        z = u * self.base_scale_diag + self.base_location
        logq = self._base_log_prob(u)

        ks, params = self._layer_params()

        def layer(carry, inp):
            z, logq = carry
            k, p = inp
            m = self._mask(k)
            s, t = self._st(m * z, p)
            z_new = m * z + (1.0 - m) * (z * jnp.exp(s) + t)
            logq = logq - jnp.sum((1.0 - m) * s, axis=-1)
            return (z_new, logq), None

        (z, logq), _ = jax.lax.scan(layer, (z, logq), (ks, params))
        return z, logq

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        return self.sample_and_log_prob(key, n_samples)[0]

    def log_prob(self, z: jax.Array) -> jax.Array:
        """Density at arbitrary points via the analytic inverse (STL path)."""
        squeeze = z.ndim == 1
        if squeeze:
            z = z[None, :]
        ks, params = self._layer_params()

        def inv_layer(carry, inp):
            y, acc = carry
            k, p = inp
            m = self._mask(k)
            s, t = self._st(m * y, p)
            z_prev = m * y + (1.0 - m) * (y - t) * jnp.exp(-s)
            return (z_prev, acc + jnp.sum((1.0 - m) * s, axis=-1)), None

        (z0, acc), _ = jax.lax.scan(
            inv_layer, (z, jnp.zeros(z.shape[0], z.dtype)), (ks, params),
            reverse=True,
        )
        u = (z0 - self.base_location) / self.base_scale_diag
        logq = self._base_log_prob(u) - acc
        return logq[0] if squeeze else logq


def coupling_flow(
    key: jax.Array,
    dim: int,
    n_layers: int = 8,
    hidden: int = 32,
    dtype=jnp.float32,
) -> CouplingFlowFamily:
    """Fresh identity-initialized affine-coupling flow (W2 = 0 => s = t = 0)."""
    k1 = key
    scale = 1.0 / math.sqrt(dim)
    return CouplingFlowFamily(
        base_location=jnp.zeros(dim, dtype),
        base_scale_diag=jnp.ones(dim, dtype),
        W1=scale * jax.random.normal(k1, (n_layers, dim, hidden), dtype),
        b1=jnp.zeros((n_layers, hidden), dtype),
        W2=jnp.zeros((n_layers, hidden, 2 * dim), dtype),
        b2=jnp.zeros((n_layers, 2 * dim), dtype),
    )


@pytree_dataclass
class FlowELBO:
    """ELBO for families with ``sample_and_log_prob``.

    Drop-in objective for ParamSpaceSGD: grad of
    ``-(E[log pi(z)] - E[log q(z)])`` with reparameterized z.

    ``entropy``: "monte_carlo" (default; density along the sampling path —
    works for every flow) or "stl" (sticking-the-landing: the entropy term
    is the frozen density evaluated at the live samples, leaving only the
    path derivative — requires the family to implement ``log_prob``, i.e. an
    analytic inverse such as CouplingFlowFamily's).
    """

    n_samples: int = static_field(default=1)
    mc_axis: Optional[str] = static_field(default=None)
    entropy: str = static_field(default="monte_carlo")

    def __post_init__(self):
        if self.entropy not in ("monte_carlo", "stl"):
            raise ValueError(
                "FlowELBO entropy must be 'monte_carlo' or 'stl', got "
                f"{self.entropy!r}"
            )

    def init(self, key, q, prob):
        if self.entropy == "stl" and not hasattr(q, "log_prob"):
            raise ValueError(
                "FlowELBO(entropy='stl') requires a family with log_prob "
                "(an analytic flow inverse, e.g. CouplingFlowFamily); "
                f"{type(q).__name__} tracks density only along the sampling "
                "path."
            )
        return ()

    def loss(self, q, prob, key: jax.Array) -> jax.Array:
        from ..core.pytree import tree_stop_gradient
        from ..objectives.repgradelbo import _constrain_mc

        z, logq = q.sample_and_log_prob(key, self.n_samples)
        z = _constrain_mc(z, self.mc_axis)
        if self.entropy == "stl":
            q_stop = tree_stop_gradient(q)
            ent = -jnp.mean(q_stop.log_prob(z))
        else:
            ent = -jnp.mean(logq)
        energy = jnp.mean(jax.vmap(prob.log_density)(z))
        return -(energy + ent)

    def _loss_and_aux(self, q, prob, key: jax.Array):
        nelbo = self.loss(q, prob, key)
        return nelbo, {"elbo": -nelbo}

    def value_and_grad(self, q, prob, key: jax.Array, obj_state=()):
        (_, info), grad = jax.value_and_grad(
            self._loss_and_aux, has_aux=True
        )(q, prob, key)
        return grad, obj_state, info

    def estimate_objective(self, key, q, prob, n_samples=None):
        n = n_samples if n_samples is not None else self.n_samples
        z, logq = q.sample_and_log_prob(key, n)
        return -(jnp.mean(jax.vmap(prob.log_density)(z)) - jnp.mean(logq))
