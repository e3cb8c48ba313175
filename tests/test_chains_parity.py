"""Vmapped chains (parallel/chains.py) against single-chain runs.

Chain k of a vmapped run must be the run that ``alg.step`` makes alone from
chain k's key and initial family, including when the chains carry their own
learning rates in the optimizer state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu.models.normal import normal_fullrank
from advancedvi_jl_tpu.parallel.chains import init_chains, step_chains

K = 4
D = 3
STEPS = 15


def _single_run(alg, key, q, target, steps, opt_state=None):
    st = alg.init(key, q, target)
    if opt_state is not None:
        st = st.replace(opt_state=opt_state)
    step = jax.jit(alg.step)
    elbos = []
    for _ in range(steps):
        st, info = step(st)
        elbos.append(float(info["elbo"]))
    return st, np.asarray(elbos)


def _chain_run(alg, states, axes, steps):
    step = jax.jit(lambda s: step_chains(alg, s, axes))
    elbos = []
    for _ in range(steps):
        states, info = step(states)
        elbos.append(np.asarray(info["elbo"]))
    return states, np.stack(elbos, axis=1)  # (K, steps)


def _family(fam, loc):
    if fam == "meanfield":
        return avt.MeanFieldGaussian(loc, jnp.ones(D))
    return avt.FullRankGaussian(loc)


@pytest.fixture(scope="module")
def target():
    return normal_fullrank(jax.random.key(31), D)[0]


@pytest.mark.parametrize("fam", ["meanfield", "fullrank"])
@pytest.mark.parametrize("opt", ["adam", "dowg"])
def test_each_chain_is_its_single_run(fam, opt, target):
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=4, operator=avt.ClipScale(),
        optimizer=optax.adam(1e-2) if opt == "adam" else avt.dowg(),
    )
    locs = 0.3 * jax.random.normal(jax.random.key(2), (K, D))
    qs = jax.vmap(lambda l: _family(fam, l))(locs)
    key = jax.random.key(7)
    states, axes = init_chains(key, alg, qs, target, K, stacked=True)
    states, elbos = _chain_run(alg, states, axes, STEPS)
    keys = jax.random.split(key, K)
    for k in range(K):
        st, e = _single_run(alg, keys[k], _family(fam, locs[k]), target, STEPS)
        np.testing.assert_allclose(elbos[k], e, rtol=1e-5, atol=1e-5)
        for a, b in zip(jax.tree.leaves(alg.output(st)),
                        jax.tree.leaves(jax.tree.map(lambda x: x[k],
                                        jax.vmap(alg.output, in_axes=(axes,))(
                                            states)))):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fam", ["meanfield", "fullrank"])
def test_per_chain_learning_rates(fam, target):
    """Descent keeps its step size in the optimizer state, so a stacked
    state can carry one learning rate per chain; each chain then matches a
    single run at its own rate."""
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=4, operator=avt.ClipScale(),
        optimizer=avt.descent(1e-3),
    )
    lrs = jnp.asarray([1e-3, 3e-3, 1e-2, 3e-2])
    q0 = _family(fam, jnp.zeros(D))
    key = jax.random.key(8)
    states, axes = init_chains(key, alg, q0, target, K)
    states = states.replace(opt_state=states.opt_state._replace(lr=lrs))
    states, elbos = _chain_run(alg, states, axes, STEPS)
    keys = jax.random.split(key, K)
    finals = []
    for k in range(K):
        st0 = alg.init(keys[k], q0, target)
        st, e = _single_run(alg, keys[k], q0, target, STEPS,
                            opt_state=st0.opt_state._replace(lr=lrs[k]))
        np.testing.assert_allclose(elbos[k], e, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(states.q.location[k]), np.asarray(st.q.location),
            rtol=1e-5, atol=1e-6,
        )
        finals.append(np.asarray(st.q.location))
    # the rates really differ: the chains moved by different amounts
    moved = [np.linalg.norm(f) for f in finals]
    assert moved[0] < moved[-1]


def test_chain_keys_are_the_split_keys(target):
    """init_chains hands chain k the k-th key of jax.random.split(key, K)."""
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=2,
                                  operator=avt.ClipScale())
    key = jax.random.key(9)
    states, _ = init_chains(key, alg, _family("meanfield", jnp.zeros(D)),
                            target, K)
    keys = jax.random.split(key, K)
    for k in range(K):
        single = alg.init(keys[k], _family("meanfield", jnp.zeros(D)), target)
        np.testing.assert_array_equal(
            jax.random.key_data(states.key[k]),
            jax.random.key_data(single.key),
        )
