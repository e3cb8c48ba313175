"""Bijective transforms for constrained supports (first-class Transform module).

AdvancedVI v0.7 removed its Bijectors extension and pushes constrained-support
handling onto the user via a ``TransformedLogDensityProblem`` wrapper pattern
(reference: README.md:91-120, HISTORY.md "Release 0.7").  Here transforms are
first-class: each maps an *unconstrained* vector to the model's constrained
support with a fused log-det-Jacobian, so the whole
``sample -> transform -> log_density + ldj`` path stays inside one jitted XLA
program (no host round trips, everything fuses).

Conventions: ``forward`` maps unconstrained -> constrained (the reference's
``binv``); ``forward_and_ldj`` returns ``(constrained, log|det J_forward|)``.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from .problem import order_of
from .pytree import pytree_dataclass, static_field


class Transform:
    """Base class: elementwise or block bijection with log-det-Jacobian."""

    def forward(self, x: jax.Array) -> jax.Array:
        return self.forward_and_ldj(x)[0]

    def forward_and_ldj(self, x: jax.Array) -> Tuple[jax.Array, jax.Array]:
        raise NotImplementedError

    def inverse(self, y: jax.Array) -> jax.Array:
        raise NotImplementedError

    def unconstrained_dim(self, constrained_dim: int) -> int:
        """Input (unconstrained) dimension for a given output dimension.

        Identity for elementwise transforms; dimension-changing bijections
        (simplex) override.  The VI family lives in the unconstrained space,
        so ``TransformedTarget.dim`` reports this.
        """
        return constrained_dim


@pytree_dataclass
class Identity(Transform):
    def forward_and_ldj(self, x):
        return x, jnp.zeros((), dtype=x.dtype)

    def inverse(self, y):
        return y


@pytree_dataclass
class Exp(Transform):
    """Unconstrained -> positive via exp; ldj = sum(x)."""

    def forward_and_ldj(self, x):
        return jnp.exp(x), jnp.sum(x)

    def inverse(self, y):
        return jnp.log(y)


@pytree_dataclass
class Softplus(Transform):
    """Unconstrained -> positive via softplus; numerically stabler than exp."""

    def forward_and_ldj(self, x):
        y = jax.nn.softplus(x)
        # d softplus / dx = sigmoid(x); log sigmoid = -softplus(-x)
        ldj = jnp.sum(-jax.nn.softplus(-x))
        return y, ldj

    def inverse(self, y):
        # softplus^-1(y) = log(expm1(y)) = y + log1p(-exp(-y))
        return y + jnp.log(-jnp.expm1(-y))


@pytree_dataclass
class Sigmoid(Transform):
    """Unconstrained -> (lo, hi) via scaled logistic sigmoid."""

    lo: float = static_field(default=0.0)
    hi: float = static_field(default=1.0)

    def forward_and_ldj(self, x):
        s = jax.nn.sigmoid(x)
        width = self.hi - self.lo
        y = self.lo + width * s
        # log |dy/dx| = log(width) + log s + log (1 - s)
        ldj = jnp.sum(
            jnp.log(width) - jax.nn.softplus(-x) - jax.nn.softplus(x)
        )
        return y, ldj

    def inverse(self, y):
        u = (y - self.lo) / (self.hi - self.lo)
        return jnp.log(u) - jnp.log1p(-u)


@pytree_dataclass
class StickBreakingSimplex(Transform):
    """Unconstrained R^{K-1} -> K-simplex via stick-breaking (the standard
    Stan/Bijectors construction).  ldj = sum_k [log s_k + log z_k + log(1-z_k)]
    where z_k = sigmoid(x_k - log(K - 1 - k)) and s_k is the remaining stick.
    """

    def forward_and_ldj(self, x):
        km1 = x.shape[-1]
        k_idx = jnp.arange(km1, dtype=x.dtype)
        adj = jnp.log(jnp.asarray(km1, x.dtype) - k_idx)
        z = jax.nn.sigmoid(x - adj)

        def body(rem, zk):
            yk = rem * zk
            # d y_k / d x_k = rem * z_k (1 - z_k); accumulate log terms
            ldj_k = jnp.log(rem) + jnp.log(zk) + jnp.log1p(-zk)
            return rem - yk, (yk, ldj_k)

        rem, (ys, ldjs) = jax.lax.scan(body, jnp.ones((), x.dtype), z)
        y = jnp.concatenate([ys, rem[None]])
        return y, jnp.sum(ldjs)

    def inverse(self, y):
        k = y.shape[-1]
        km1 = k - 1
        rem = 1.0 - jnp.concatenate(
            [jnp.zeros((1,), y.dtype), jnp.cumsum(y[:-1])]
        )[:km1]
        z = y[:km1] / rem
        adj = jnp.log(
            jnp.asarray(km1, y.dtype) - jnp.arange(km1, dtype=y.dtype)
        )
        return jnp.log(z) - jnp.log1p(-z) + adj

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return constrained_dim - 1


@pytree_dataclass
class Ordered(Transform):
    """Unconstrained R^K -> strictly increasing vectors:
    y_1 = x_1, y_k = y_{k-1} + exp(x_k); ldj = sum_{k>=2} x_k."""

    def forward_and_ldj(self, x):
        incr = jnp.concatenate([x[:1], jnp.exp(x[1:])])
        y = jnp.cumsum(incr)
        return y, jnp.sum(x[1:])

    def inverse(self, y):
        return jnp.concatenate([y[:1], jnp.log(jnp.diff(y))])


@pytree_dataclass
class Stacked(Transform):
    """Apply different transforms to contiguous slices of the vector.

    Analogue of ``Bijectors.Stacked`` used in the reference's
    flagship logistic-regression example (reference: README.md:91-104), e.g.
    identity on regression weights, exp on the positive scale parameter.
    Slices are static, so XLA sees fixed gathers and fuses everything.
    """

    transforms: tuple = static_field()
    sizes: tuple = static_field()

    def forward_and_ldj(self, x):
        pieces = []
        ldj = jnp.zeros((), dtype=x.dtype)
        offset = 0
        for t, n in zip(self.transforms, self.sizes):
            # offsets are Python ints: a static slice, not a dynamic_slice
            y, l = t.forward_and_ldj(x[offset : offset + n])
            pieces.append(y)
            ldj = ldj + l
            offset += n
        return jnp.concatenate(pieces), ldj

    def inverse(self, y):
        pieces = []
        offset = 0
        for t, n in zip(self.transforms, self.sizes):
            # output size of this block (differs from n for dim-changing
            # transforms like the simplex)
            n_out = t.forward(jnp.zeros((n,), y.dtype)).shape[0]
            pieces.append(t.inverse(y[offset : offset + n_out]))
            offset += n_out
        return jnp.concatenate(pieces)

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return sum(self.sizes)


def stacked(*pairs: Tuple[Transform, int]) -> Stacked:
    transforms, sizes = zip(*pairs)
    return Stacked(transforms=tuple(transforms), sizes=tuple(sizes))


@pytree_dataclass
class Blockwise(Transform):
    """Apply one block transform independently to ``n_blocks`` contiguous
    blocks of the vector (vmapped), e.g. a batch of simplices: a (B, K)
    Dirichlet site is B independent K-simplices, NOT one (B*K)-simplex.
    ``block_in``/``block_out`` are the per-block unconstrained/constrained
    sizes (they differ for dimension-changing bijections)."""

    inner: Transform = static_field()
    n_blocks: int = static_field()
    block_in: int = static_field()
    block_out: int = static_field()

    def forward_and_ldj(self, x):
        xb = x.reshape(self.n_blocks, self.block_in)
        y, ldj = jax.vmap(self.inner.forward_and_ldj)(xb)
        return y.reshape(-1), jnp.sum(ldj)

    def inverse(self, y):
        yb = y.reshape(self.n_blocks, self.block_out)
        return jax.vmap(self.inner.inverse)(yb).reshape(-1)

    def unconstrained_dim(self, constrained_dim: int) -> int:
        return self.n_blocks * self.block_in


@pytree_dataclass
class TransformedTarget:
    """Change-of-variables wrapper: unconstrained-space log density.

    ``log_density(x) = prob.log_density(T(x)) + log|det J_T(x)|`` — the
    Analogue of the reference's user-side
    ``TransformedLogDensityProblem`` (reference: README.md:105-140), but built
    in so the Jacobian term fuses into the jitted ELBO path.
    """

    prob: Any
    transform: Transform = static_field()

    @property
    def dim(self) -> int:
        """Dimension of the UNCONSTRAINED space (where the VI family lives)."""
        d = getattr(self.prob, "dim")
        d = d() if callable(d) else int(d)
        return self.transform.unconstrained_dim(d)

    def order(self) -> int:
        return order_of(self.prob)

    def log_density(self, x: jax.Array) -> jax.Array:
        theta, ldj = self.transform.forward_and_ldj(x)
        return self.prob.log_density(theta) + ldj

    def subsample(self, indices):
        sub = getattr(self.prob, "subsample", None)
        if sub is None:
            return self
        return TransformedTarget(prob=sub(indices), transform=self.transform)


@pytree_dataclass
class TransformedDistribution:
    """Push a variational family through a transform (constrained posterior).

    Analogue of wrapping the optimum in ``Bijectors.TransformedDistribution``
    at the end of the reference's README example (reference: README.md:199-202).
    """

    base: Any
    transform: Transform = static_field()

    def sample(self, key: jax.Array, n_samples: int) -> jax.Array:
        z = self.base.sample(key, n_samples)
        return jax.vmap(self.transform.forward)(z)

    def log_prob(self, y: jax.Array) -> jax.Array:
        """Density in constrained space; handles single points and (n, d)
        batches (transforms are written for single vectors, so batches are
        vmapped — a batched call to forward_and_ldj would sum the Jacobian
        over the whole batch)."""

        def single(yy):
            x = self.transform.inverse(yy)
            _, ldj = self.transform.forward_and_ldj(x)
            return self.base.log_prob(x) - ldj

        if y.ndim == 1:
            return single(y)
        return jax.vmap(single)(y)
