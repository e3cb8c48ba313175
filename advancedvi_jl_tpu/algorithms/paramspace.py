"""Parameter-space SGD algorithms (ADVI / proximal ADVI / BBVI).

Redesign of the shared ``ParamSpaceSGD`` machinery
(reference: src/algorithms/common.jl:7-120 and constructors.jl).  The whole
step body — gradient estimate, optimizer update, operator projection, Polyak
averaging — is ONE pure function over pytrees, jitted (and `lax.scan`-able)
by the driver.  The reference's per-step destructure/restructure round trip
disappears: the family pytree is the parameter vector.

Divergence handling: the reference throws on a non-finite objective
(common.jl:83-89).  Inside jit we cannot throw, so the step emits a
``diverged`` flag in ``info``; the driver raises host-side.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax

from ..core.pytree import pytree_dataclass
from ..families.location_scale import is_location_scale
from ..objectives.entropy import (
    CLOSED_FORM,
    CLOSED_FORM_ZERO_GRAD,
    MONTE_CARLO,
    STL,
    ZERO_GRAD_ESTIMATORS,
)
from ..objectives.repgradelbo import RepGradELBO
from ..objectives.scoregradelbo import ScoreGradELBO
from ..objectives.subsampled import SubsampledObjective
from ..optim.averaging import PolynomialAveraging
from ..optim.operators import (
    IdentityOperator,
    ProximalLocationScaleEntropy,
)
from ..optim.rules import dowg


@pytree_dataclass
class ParamSpaceSGDState:
    """Warm-startable optimization state (a pure pytree -> checkpointable).

    Mirrors the reference's state NamedTuple (common.jl:52-60); the PRNG key
    is part of the state so a checkpointed-and-resumed run is bit-identical to
    an uninterrupted one (reference invariant: test/general/optimize.jl:30-41).
    """

    prob: Any
    q: Any
    iteration: jax.Array
    opt_state: Any
    obj_state: Any
    avg_state: Any
    key: jax.Array


def _validate_target(prob, objective) -> None:
    """Early, readable errors for the two common target mistakes.

    (a) The target must be a pytree of arrays — it is threaded through jit /
        lax.scan as part of the algorithm state.  Plain Python objects fail
        deep inside jit with an opaque pytree error; catch it here instead.
    (b) RepGrad objectives require a differentiable target (capability
        order >= 1) — the reference makes the same check in
        ``RepGradELBO.init`` (repgradelbo.jl:41-70).
    """
    from ..core.problem import ORDER_VALUE_ONLY, order_of

    from ..core.problem import validate_pytree_target

    validate_pytree_target(prob)
    inner = getattr(objective, "objective", objective)
    if isinstance(inner, RepGradELBO) and order_of(prob) <= ORDER_VALUE_ONLY:
        raise ValueError(
            "Target has capability order 0 (value-only, not differentiable)."
            " Reparameterization-gradient objectives require a "
            "differentiable target; use KLMinScoreGradDescent instead."
        )


class ParamSpaceSGD:
    """Shared init/step/output for parameter-space SGD algorithms."""

    # The driver's callback mode may request the raw gradient pytree via
    # step(state, with_grad=True) — callback payload parity with the
    # reference's (rng, iteration, restructure, params, averaged_params,
    # gradient, state) contract (common.jl:106-118).
    supports_grad = True

    def __init__(self, objective, optimizer, averager, operator):
        self.objective = objective
        self.optimizer = optimizer
        self.averager = averager
        self.operator = operator

    def init(self, key: jax.Array, q_init, prob) -> ParamSpaceSGDState:
        _validate_target(prob, self.objective)
        if is_location_scale(q_init) and isinstance(
            self.operator, IdentityOperator
        ):
            warnings.warn(
                "IdentityOperator is used with a location-scale variational "
                "family. Optimization can fail due to singular scale "
                "matrices; consider using ClipScale. "
                "(reference behavior: common.jl:42-46)"
            )
        obj_key, state_key = jax.random.split(key)
        return ParamSpaceSGDState(
            prob=prob,
            q=q_init,
            iteration=jnp.asarray(0, jnp.int32),
            opt_state=self.optimizer.init(q_init),
            obj_state=self.objective.init(obj_key, q_init, prob),
            avg_state=self.averager.init(q_init),
            key=state_key,
        )

    def step(self, state: ParamSpaceSGDState, with_grad: bool = False):
        """One SGD step; pure and jit/scan-safe (reference: common.jl:69-120).

        ``with_grad=True`` (static) additionally returns the gradient pytree
        under ``info["gradient"]`` — used by the driver's callback mode only
        (never by the scan paths, where stacking it would be O(steps * d)).
        """
        it = state.iteration
        step_key = jax.random.fold_in(state.key, it)

        grad, obj_state, info = self.objective.value_and_grad(
            state.q, state.prob, step_key, state.obj_state
        )
        if with_grad:
            info = {**info, "gradient": grad}
        updates, opt_state = self.optimizer.update(
            grad, state.opt_state, state.q
        )
        q_new = optax.apply_updates(state.q, updates)
        q_new = self.operator.apply(q_new, opt_state)
        avg_state = self.averager.apply(state.avg_state, q_new)

        info["diverged"] = ~jnp.isfinite(info["elbo"])
        new_state = ParamSpaceSGDState(
            prob=state.prob,
            q=q_new,
            iteration=it + 1,
            opt_state=opt_state,
            obj_state=obj_state,
            avg_state=avg_state,
            key=state.key,
        )
        return new_state, info

    def output(self, state: ParamSpaceSGDState):
        """Family built from the averaged parameters (common.jl:63-67)."""
        return self.averager.value(state.avg_state)

    def estimate_objective(
        self,
        key: jax.Array,
        q,
        prob,
        n_samples: Optional[int] = None,
        entropy: str = MONTE_CARLO,
    ):
        """-ELBO via RepGrad + Monte-Carlo entropy, regardless of the training
        objective (reference: common.jl:29-38; ``entropy`` overrides the
        evaluation estimator like the reference kwarg).  Families without a
        ``log_prob`` (e.g. flows, which track density only along the sampling
        path) fall back to the training objective's own estimator.

        Subsampling note (same contract as the reference): this evaluates on
        whatever ``prob`` the caller passes — it does NOT recover the
        training objective's subsampling wrapper.  For the epoch-swept
        minibatch average of the full objective, call
        ``SubsampledObjective.estimate_objective`` on the training objective
        itself."""
        n = n_samples if n_samples is not None else self.objective.n_samples
        if not hasattr(q, "log_prob"):
            return self.objective.estimate_objective(key, q, prob, n)
        obj = RepGradELBO(n_samples=n, entropy=entropy)
        return obj.estimate_objective(key, q, prob)


def KLMinRepGradDescent(
    entropy: str = CLOSED_FORM,
    optimizer: Optional[optax.GradientTransformation] = None,
    n_samples: int = 1,
    averager=None,
    operator=None,
    subsampling=None,
    mc_axis: Optional[str] = None,
    antithetic: bool = False,
    fast_entropy: bool = True,
) -> ParamSpaceSGD:
    """ADVI: SGD on the reparameterization-gradient ELBO
    (reference: constructors.jl:44-79; defaults DoWG + polynomial averaging).
    """
    if entropy not in (CLOSED_FORM, STL, MONTE_CARLO):
        raise ValueError(
            "KLMinRepGradDescent supports closed_form / stl / monte_carlo "
            f"entropy, got {entropy!r}; use KLMinRepGradProxDescent for "
            "zero-gradient variants."
        )
    objective = RepGradELBO(
        n_samples=n_samples, entropy=entropy, mc_axis=mc_axis,
        antithetic=antithetic, fast_entropy=fast_entropy,
    )
    if subsampling is not None:
        objective = SubsampledObjective(objective=objective, subsampling=subsampling)
    return ParamSpaceSGD(
        objective=objective,
        optimizer=optimizer if optimizer is not None else dowg(),
        averager=averager if averager is not None else PolynomialAveraging(),
        operator=operator if operator is not None else IdentityOperator(),
    )


ADVI = KLMinRepGradDescent


def KLMinRepGradProxDescent(
    entropy_zerograd: str = CLOSED_FORM_ZERO_GRAD,
    optimizer: Optional[optax.GradientTransformation] = None,
    n_samples: int = 1,
    averager=None,
    subsampling=None,
    mc_axis: Optional[str] = None,
) -> ParamSpaceSGD:
    """Proximal ADVI: the entropy enters through a closed-form proximal step,
    so the gradient estimator must have a zero-mean entropy gradient and the
    optimizer step size must be extractable (reference: constructors.jl:122-157).
    """
    if entropy_zerograd not in ZERO_GRAD_ESTIMATORS:
        raise ValueError(
            "KLMinRepGradProxDescent requires a zero-gradient entropy "
            f"estimator {ZERO_GRAD_ESTIMATORS}, got {entropy_zerograd!r}"
        )
    objective = RepGradELBO(
        n_samples=n_samples, entropy=entropy_zerograd, mc_axis=mc_axis
    )
    if subsampling is not None:
        objective = SubsampledObjective(objective=objective, subsampling=subsampling)
    return ParamSpaceSGD(
        objective=objective,
        optimizer=optimizer if optimizer is not None else dowg(),
        averager=averager if averager is not None else PolynomialAveraging(),
        operator=ProximalLocationScaleEntropy(),
    )


def KLMinScoreGradDescent(
    optimizer: Optional[optax.GradientTransformation] = None,
    n_samples: int = 2,
    averager=None,
    operator=None,
    subsampling=None,
    mc_axis: Optional[str] = None,
) -> ParamSpaceSGD:
    """BBVI: SGD on the score-function (VarGrad) gradient
    (reference: constructors.jl:199-233)."""
    objective = ScoreGradELBO(n_samples=n_samples, mc_axis=mc_axis)
    if subsampling is not None:
        objective = SubsampledObjective(objective=objective, subsampling=subsampling)
    return ParamSpaceSGD(
        objective=objective,
        optimizer=optimizer if optimizer is not None else dowg(),
        averager=averager if averager is not None else PolynomialAveraging(),
        operator=operator if operator is not None else IdentityOperator(),
    )


BBVI = KLMinScoreGradDescent
