"""Distributions for the model-ingestion DSL (ppl.model).

Each distribution is a small pytree with ``log_prob`` (elementwise,
jax-traceable), ``sample`` (prior draws, used only for trace-time shape/
support discovery and prior-predictive utilities), and a ``support`` tag the
ingestion layer maps onto a Transform (core/transforms.py) to assemble the
constrained -> unconstrained bijection automatically — the analogue of the DynamicPPL bridge's varinfo-driven linking
(reference: ext/AdvancedVIDynamicPPLExt.jl:72-123).

Discrete distributions carry ``support = "discrete"`` and are only valid as
OBSERVED sites (VI over discrete latents is out of scope, as in the
reference).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import betaln, gammaln

from ..core.pytree import pytree_dataclass, static_field

_LOG_2PI = math.log(2.0 * math.pi)


def _bshape(*xs):
    return jnp.broadcast_shapes(*(jnp.shape(x) for x in xs))


@pytree_dataclass
class Normal:
    loc: jax.Array = 0.0
    scale: jax.Array = 1.0
    support: str = static_field(default="real")

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z) - jnp.log(self.scale) - 0.5 * _LOG_2PI

    def sample(self, key, shape=None):
        shape = _bshape(self.loc, self.scale) if shape is None else shape
        return self.loc + self.scale * jax.random.normal(key, shape)


@pytree_dataclass
class LogNormal:
    loc: jax.Array = 0.0
    scale: jax.Array = 1.0
    support: str = static_field(default="positive")

    def log_prob(self, x):
        lx = jnp.log(x)
        z = (lx - self.loc) / self.scale
        return -0.5 * (z * z) - jnp.log(self.scale) - 0.5 * _LOG_2PI - lx

    def sample(self, key, shape=None):
        shape = _bshape(self.loc, self.scale) if shape is None else shape
        return jnp.exp(self.loc + self.scale * jax.random.normal(key, shape))


@pytree_dataclass
class HalfNormal:
    scale: jax.Array = 1.0
    support: str = static_field(default="positive")

    def log_prob(self, x):
        z = x / self.scale
        return (
            math.log(2.0) - 0.5 * (z * z) - jnp.log(self.scale)
            - 0.5 * _LOG_2PI
        )

    def sample(self, key, shape=None):
        shape = _bshape(self.scale) if shape is None else shape
        return self.scale * jnp.abs(jax.random.normal(key, shape))


@pytree_dataclass
class HalfCauchy:
    scale: jax.Array = 1.0
    support: str = static_field(default="positive")

    def log_prob(self, x):
        z = x / self.scale
        return (
            math.log(2.0 / math.pi) - jnp.log(self.scale) - jnp.log1p(z * z)
        )

    def sample(self, key, shape=None):
        shape = _bshape(self.scale) if shape is None else shape
        return self.scale * jnp.abs(jax.random.cauchy(key, shape))


@pytree_dataclass
class Exponential:
    rate: jax.Array = 1.0
    support: str = static_field(default="positive")

    def log_prob(self, x):
        return jnp.log(self.rate) - self.rate * x

    def sample(self, key, shape=None):
        shape = _bshape(self.rate) if shape is None else shape
        return jax.random.exponential(key, shape) / self.rate


@pytree_dataclass
class Gamma:
    concentration: jax.Array = 1.0
    rate: jax.Array = 1.0
    support: str = static_field(default="positive")

    def log_prob(self, x):
        a, b = self.concentration, self.rate
        return a * jnp.log(b) + (a - 1.0) * jnp.log(x) - b * x - gammaln(a)

    def sample(self, key, shape=None):
        shape = _bshape(self.concentration, self.rate) if shape is None else shape
        return jax.random.gamma(key, self.concentration, shape) / self.rate


@pytree_dataclass
class Beta:
    a: jax.Array = 1.0
    b: jax.Array = 1.0
    support: str = static_field(default="unit_interval")

    def log_prob(self, x):
        return (
            (self.a - 1.0) * jnp.log(x)
            + (self.b - 1.0) * jnp.log1p(-x)
            - betaln(self.a, self.b)
        )

    def sample(self, key, shape=None):
        shape = _bshape(self.a, self.b) if shape is None else shape
        return jax.random.beta(key, self.a, self.b, shape)


@pytree_dataclass
class Uniform:
    lo: float = static_field(default=0.0)  # static: defines the support
    hi: float = static_field(default=1.0)
    support: str = static_field(default="interval")

    def log_prob(self, x):
        return jnp.full(jnp.shape(x), -math.log(self.hi - self.lo))

    def sample(self, key, shape=None):
        shape = () if shape is None else shape
        return jax.random.uniform(
            key, shape, minval=self.lo, maxval=self.hi
        )


@pytree_dataclass
class StudentT:
    df: float = static_field(default=5.0)
    loc: jax.Array = 0.0
    scale: jax.Array = 1.0
    support: str = static_field(default="real")

    def log_prob(self, x):
        nu = self.df
        z = (x - self.loc) / self.scale
        lognorm = (
            gammaln((nu + 1.0) / 2.0)
            - gammaln(nu / 2.0)
            - 0.5 * math.log(nu * math.pi)
        )
        return (
            lognorm
            - (nu + 1.0) / 2.0 * jnp.log1p(z * z / nu)
            - jnp.log(self.scale)
        )

    def sample(self, key, shape=None):
        shape = _bshape(self.loc, self.scale) if shape is None else shape
        return self.loc + self.scale * jax.random.t(key, self.df, shape)


@pytree_dataclass
class Laplace:
    loc: jax.Array = 0.0
    scale: jax.Array = 1.0
    support: str = static_field(default="real")

    def log_prob(self, x):
        return (
            -jnp.abs(x - self.loc) / self.scale
            - jnp.log(2.0 * self.scale)
        )

    def sample(self, key, shape=None):
        shape = _bshape(self.loc, self.scale) if shape is None else shape
        return self.loc + self.scale * jax.random.laplace(key, shape)


@pytree_dataclass
class Dirichlet:
    concentration: jax.Array = None
    support: str = static_field(default="simplex")

    def log_prob(self, x):
        a = self.concentration
        # returns the JOINT density as the last-axis reduction (simplex is a
        # block support, not elementwise); the site sums it once more, which
        # is a no-op for scalars.
        return (
            jnp.sum((a - 1.0) * jnp.log(x), axis=-1)
            - jnp.sum(gammaln(a), axis=-1)
            + gammaln(jnp.sum(a, axis=-1))
        )

    def sample(self, key, shape=None):
        return jax.random.dirichlet(key, self.concentration)


# --- observation-only (discrete) distributions -----------------------------


@pytree_dataclass
class Bernoulli:
    logits: jax.Array = 0.0
    support: str = static_field(default="discrete")

    def log_prob(self, y):
        # y in {0, 1}: y * l - softplus(l)  (logit parameterization)
        return y * self.logits - jax.nn.softplus(self.logits)

    def sample(self, key, shape=None):
        shape = _bshape(self.logits) if shape is None else shape
        return jax.random.bernoulli(
            key, jax.nn.sigmoid(self.logits), shape
        ).astype(jnp.float32)


@pytree_dataclass
class Poisson:
    rate: jax.Array = 1.0
    support: str = static_field(default="discrete")

    def log_prob(self, y):
        return y * jnp.log(self.rate) - self.rate - gammaln(y + 1.0)

    def sample(self, key, shape=None):
        shape = _bshape(self.rate) if shape is None else shape
        return jax.random.poisson(key, self.rate, shape).astype(jnp.float32)


@pytree_dataclass
class Categorical:
    logits: jax.Array = None
    support: str = static_field(default="discrete")

    def log_prob(self, y):
        logp = jax.nn.log_softmax(self.logits, axis=-1)
        y = jnp.asarray(y).astype(jnp.int32)
        if logp.ndim == 1:  # shared class probabilities, batched labels
            return logp[y]
        return jnp.take_along_axis(logp, y[..., None], axis=-1)[..., 0]

    def sample(self, key, shape=None):
        return jax.random.categorical(key, self.logits)
