"""The general ``optimize`` path across optimizer x operator x entropy x family.

Every supported combination must (a) give the same result bit for bit when
the run is cut into chunks and resumed from a checkpoint file as when it runs
uninterrupted, and (b) train: a finite ELBO at every step and a lower
neg-ELBO at the end than at the start.  Proximal descent needs a step size
the operator can read from the optimizer state (Descent, DoG, DoWG); the
rules without one (Adam, COCOB) must be refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu.models.normal import normal_fullrank
from advancedvi_jl_tpu.utils.checkpoint import restore_state, save_state

D = 4
STEPS = 40
CHUNK = 10

OPTIMIZERS = {
    "adam": lambda: optax.adam(3e-2),
    "descent": lambda: avt.descent(2e-2),
    "dowg": lambda: avt.dowg(),
    "dog": lambda: avt.dog(),
    "cocob": lambda: avt.cocob(),
}
HAS_STEPSIZE = {"descent", "dowg", "dog"}
OPERATORS = ("clipscale", "identity", "proximal")
ENTROPIES = (avt.STL, avt.CLOSED_FORM_ZERO_GRAD, avt.STL_ZERO_GRAD)
FAMILIES = ("meanfield", "fullrank")


def _cases():
    for opt in OPTIMIZERS:
        for op in OPERATORS:
            for ent in ENTROPIES:
                zero_grad = ent != avt.STL
                if zero_grad != (op == "proximal"):
                    continue  # not a constructible algorithm
                for fam in FAMILIES:
                    yield pytest.param(opt, op, ent, fam,
                                       id=f"{opt}-{op}-{ent}-{fam}")


def _make_alg(opt, op, ent):
    if op == "proximal":
        return avt.KLMinRepGradProxDescent(
            entropy_zerograd=ent, optimizer=OPTIMIZERS[opt](), n_samples=4
        )
    operator = avt.ClipScale() if op == "clipscale" else avt.IdentityOperator()
    return avt.KLMinRepGradDescent(
        entropy=ent, optimizer=OPTIMIZERS[opt](), n_samples=4,
        operator=operator,
    )


def _q0(fam):
    if fam == "meanfield":
        return avt.MeanFieldGaussian(jnp.zeros(D), jnp.ones(D))
    return avt.FullRankGaussian(jnp.zeros(D))


@pytest.fixture(scope="module")
def target():
    return normal_fullrank(jax.random.key(21), D)[0]


def _neg_elbo(q, target):
    obj = avt.RepGradELBO(n_samples=4096, entropy=avt.CLOSED_FORM)
    return float(obj.estimate_objective(jax.random.key(99), q, target))


@pytest.mark.parametrize("opt,op,ent,fam", list(_cases()))
def test_chunked_resume_is_bitwise_and_trains(opt, op, ent, fam, target,
                                              tmp_path):
    key = jax.random.key(5)
    q0 = _q0(fam)
    if op == "proximal" and opt not in HAS_STEPSIZE:
        alg = _make_alg(opt, op, ent)
        with pytest.raises(ValueError, match="step size|stepsize"):
            avt.optimize(key, alg, 2, target, q0)
        return

    alg = _make_alg(opt, op, ent)
    out_full, infos_full, _ = avt.optimize(key, alg, STEPS, target, q0)

    _, infos_a, st = avt.optimize(
        key, alg, STEPS // 2, target, q0, chunk_size=CHUNK
    )
    path = str(tmp_path / "state.npz")
    save_state(path, st)
    st = restore_state(path, alg.init(key, q0, target))
    out_res, infos_b, _ = avt.optimize(
        key, alg, STEPS // 2, target, q0, state=st, chunk_size=CHUNK
    )

    for a, b in zip(jax.tree.leaves(out_full), jax.tree.leaves(out_res)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elbo_full = np.asarray([r["elbo"] for r in infos_full])
    elbo_res = np.asarray([r["elbo"] for r in infos_a + infos_b])
    np.testing.assert_array_equal(elbo_full, elbo_res)
    assert len(infos_a) + len(infos_b) == STEPS

    assert np.all(np.isfinite(elbo_full))
    assert _neg_elbo(out_full, target) < _neg_elbo(q0, target)
