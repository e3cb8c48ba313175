"""A/B equivalence of the solve-free entropy fast path (VERDICT r2 #1).

``RepGradELBO(fast_entropy=True)`` rewrites the flagship MC/STL entropy
value+gradient path via the identity ``scale⁻¹(z − location) ≡ u`` and a
hand-written ``jax.custom_vjp`` (objectives/entropy.py:95-137).  These tests
pin the "identical values AND gradients" claim against the standard path
(``estimate_entropy``, which mirrors reference src/algorithms/entropy.jl:11-90)
for every estimator x family x base x antithetic combination, so a sign or
transpose error in ``_stl_fast_bwd`` cannot ride the default hot path
undetected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu.families.base import Laplace, Normal, StudentT
from advancedvi_jl_tpu.families.location_scale import (
    FullRankLocationScale,
    MeanFieldLocationScale,
)
from advancedvi_jl_tpu.models.normal import normal_fullrank
from advancedvi_jl_tpu.objectives.entropy import (
    ALL_ENTROPY_ESTIMATORS,
    estimate_entropy,
    estimate_entropy_from_draw,
    supports_fast_entropy,
)

D = 5
BASES = {"normal": Normal(), "student_t": StudentT(df=7.0), "laplace": Laplace()}


def _make_q(qtype: str, base) -> object:
    k1, k2 = jax.random.split(jax.random.key(11))
    loc = 0.3 * jax.random.normal(k1, (D,))
    if qtype == "meanfield":
        diag = 0.5 + 0.4 * jax.random.uniform(k2, (D,))
        return MeanFieldLocationScale(location=loc, scale_diag=diag, base=base)
    A = 0.25 * jax.random.normal(k2, (D, D))
    scale = jnp.tril(A) + jnp.eye(D) * 0.8
    return FullRankLocationScale(location=loc, scale=scale, base=base)


def _grad_flat(fn, *args):
    g = jax.grad(fn)(*args)
    return np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree.leaves(g)])


@pytest.fixture(scope="module")
def target():
    prob, _, _ = normal_fullrank(jax.random.key(3), D)
    return prob


@pytest.mark.parametrize("estimator", ALL_ENTROPY_ESTIMATORS)
@pytest.mark.parametrize("qtype", ["meanfield", "fullrank"])
@pytest.mark.parametrize("base_name", list(BASES))
@pytest.mark.parametrize("antithetic", [False, True])
def test_loss_and_grad_parity(target, estimator, qtype, base_name, antithetic):
    """RepGradELBO loss value and full parameter gradient agree between
    fast_entropy=True and False for every estimator/family/base combo."""
    q = _make_q(qtype, BASES[base_name])
    assert supports_fast_entropy(q)
    key = jax.random.key(42)

    def loss_with(fast: bool, qq):
        obj = avt.RepGradELBO(
            n_samples=8,
            entropy=estimator,
            antithetic=antithetic,
            fast_entropy=fast,
        )
        return obj.loss(qq, target, key)

    v_fast = float(loss_with(True, q))
    v_slow = float(loss_with(False, q))
    # Same base draw, algebraically identical estimate; fp noise only.
    np.testing.assert_allclose(v_fast, v_slow, rtol=2e-5, atol=2e-5)

    g_fast = _grad_flat(lambda qq: loss_with(True, qq), q)
    g_slow = _grad_flat(lambda qq: loss_with(False, qq), q)
    scale = max(1.0, float(np.max(np.abs(g_slow))))
    np.testing.assert_allclose(g_fast, g_slow, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("qtype", ["meanfield", "fullrank"])
@pytest.mark.parametrize("base_name", list(BASES))
def test_stl_custom_vjp_against_autodiff(qtype, base_name):
    """The hand-written VJP of the fast STL estimator matches autodiff through
    the standard −mean log q_stop(z) path, w.r.t. the SAMPLES z (the only live
    input): this isolates the custom backward from the rest of the loss."""
    q = _make_q(qtype, BASES[base_name])
    key = jax.random.key(7)
    z, u = q.sample_with_base(key, 16)

    def fast(zz):
        return estimate_entropy_from_draw("stl", zz, u, q, q)

    def slow(zz):
        return estimate_entropy("stl", zz, q, q)

    np.testing.assert_allclose(
        float(fast(z)), float(slow(z)), rtol=2e-5, atol=2e-5
    )
    gf = np.asarray(jax.grad(fast)(z))
    gs = np.asarray(jax.grad(slow)(z))
    np.testing.assert_allclose(gf, gs, rtol=2e-4, atol=1e-6)


def test_fast_path_actually_taken_and_solve_free(target):
    """The default config routes through estimate_entropy_from_draw: the
    lowered fullrank STL VALUE path carries exactly one triangular solve less
    than the standard path (the entropy whitening solve is eliminated; the
    remaining solve belongs to the Gaussian TARGET's log-density)."""
    q = _make_q("fullrank", Normal())
    key = jax.random.key(0)

    def n_solves(fast):
        obj = avt.RepGradELBO(n_samples=4, entropy=avt.STL, fast_entropy=fast)
        txt = jax.jit(lambda qq: obj.loss(qq, target, key)).lower(q).as_text()
        # CPU lowering emits lapack trsm custom-calls OR the library's own
        # native FFI trisolve (advi_trisolve, when routed); other backends
        # emit stablehlo triangular_solve — count all spellings.  The FFI call
        # name itself contains no 'trsm'/'triangular_solve' substring.
        return (
            txt.count("trsm")
            + txt.count("triangular_solve")
            + txt.count("advi_trisolve")
        )

    assert n_solves(False) == n_solves(True) + 1


def test_end_to_end_convergence_parity(target):
    """Full ADVI runs with fast_entropy on/off land on the same posterior
    (loose check that the default hot path optimizes the same objective)."""
    results = []
    for fast in (True, False):
        alg = avt.KLMinRepGradDescent(
            entropy=avt.STL,
            n_samples=8,
            operator=avt.ClipScale(),
            fast_entropy=fast,
        )
        out, _, _ = avt.optimize(
            jax.random.key(1), alg, 300, target, avt.FullRankGaussian(jnp.zeros(D))
        )
        results.append(out)
    np.testing.assert_allclose(
        np.asarray(results[0].location),
        np.asarray(results[1].location),
        rtol=1e-3,
        atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(jnp.tril(results[0].scale)),
        np.asarray(jnp.tril(results[1].scale)),
        rtol=1e-3,
        atol=1e-3,
    )
