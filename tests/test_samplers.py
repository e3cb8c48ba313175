"""The XLA reparameterised samplers of the Gaussian families.

Each family's draw is an affine map of base normals, so both the draw and
its reparameterisation gradient have closed forms:

- mean-field  z = u * sigma + m:      dm = sum ct,  dsigma = sum(ct * u)
- full-rank   z = u C^T + m:          dm = sum ct,  dC = tril(ct^T u)
- low-rank    z = u1 * D + u2 U^T + m: dm = sum ct, dD = sum(ct * u1),
                                       dU = ct^T u2

for a cotangent ``ct`` on z.  Widths 7, 128 and 130 cover an odd width, a
power of two and one just past it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import advancedvi_jl_tpu as avt

N = 64
WIDTHS = (7, 128, 130)


def _params(d, key=0):
    rng = np.random.default_rng(key + d)
    m = jnp.asarray(rng.normal(size=d), jnp.float32)
    s = jnp.asarray(0.5 + rng.uniform(size=d), jnp.float32)
    C = jnp.asarray(
        np.tril(0.1 * rng.normal(size=(d, d))) + np.diag(0.5 + rng.uniform(size=d)),
        jnp.float32,
    )
    U = jnp.asarray(0.2 * rng.normal(size=(d, 3)), jnp.float32)
    ct = jnp.asarray(rng.normal(size=(N, d)), jnp.float32)
    return m, s, C, U, ct


def _lowrank_base(key, d, r):
    k1, k2 = jax.random.split(key)
    u1 = avt.Normal().sample(k1, (N, d), jnp.float32)
    u2 = avt.Normal().sample(k2, (N, r), jnp.float32)
    return u1, u2


@pytest.mark.parametrize("d", WIDTHS)
def test_meanfield_draw_and_gradient(d):
    m, s, _, _, ct = _params(d)
    key = jax.random.key(3)
    z, u = avt.MeanFieldGaussian(m, s).sample_with_base(key, N)
    assert z.shape == u.shape == (N, d)
    np.testing.assert_allclose(z, u * s + m, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(z, avt.MeanFieldGaussian(m, s).sample(key, N))

    dm, ds = jax.grad(
        lambda m, s: jnp.sum(avt.MeanFieldGaussian(m, s).sample(key, N) * ct),
        argnums=(0, 1),
    )(m, s)
    np.testing.assert_allclose(dm, ct.sum(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ds, (ct * u).sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", WIDTHS)
def test_fullrank_draw_and_gradient(d):
    m, _, C, _, ct = _params(d)
    key = jax.random.key(4)
    with jax.default_matmul_precision("highest"):
        z, u = avt.FullRankGaussian(m, C).sample_with_base(key, N)
        np.testing.assert_allclose(z, u @ C.T + m, rtol=1e-5, atol=1e-5)
        # the strict upper triangle of the stored scale is inert
        dirty = C + jnp.triu(jnp.ones((d, d)), 1)
        q_dirty = avt.FullRankGaussian(m).replace(scale=dirty)
        np.testing.assert_array_equal(q_dirty.sample(key, N), z)

        dm, dC = jax.grad(
            lambda m, C: jnp.sum(
                avt.FullRankGaussian(m).replace(scale=C).sample(key, N) * ct
            ),
            argnums=(0, 1),
        )(m, C)
    np.testing.assert_allclose(dm, ct.sum(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dC, np.tril(ct.T @ u), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", WIDTHS)
def test_lowrank_draw_and_gradient(d):
    m, D, _, U, ct = _params(d)
    key = jax.random.key(5)
    u1, u2 = _lowrank_base(key, d, U.shape[1])
    with jax.default_matmul_precision("highest"):
        z = avt.LowRankGaussian(m, D, U).sample(key, N)
        np.testing.assert_allclose(z, u1 * D + u2 @ U.T + m, rtol=1e-5,
                                   atol=1e-5)
        dm, dD, dU = jax.grad(
            lambda m, D, U: jnp.sum(avt.LowRankGaussian(m, D, U).sample(key, N)
                                    * ct),
            argnums=(0, 1, 2),
        )(m, D, U)
    np.testing.assert_allclose(dm, ct.sum(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dD, (ct * u1).sum(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dU, ct.T @ u2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fam", ["meanfield", "fullrank"])
@pytest.mark.parametrize("d", WIDTHS)
def test_base_draw_is_the_threefry_normal(fam, d):
    """u is exactly jax.random.normal under the given key, so every backend
    that runs threefry draws the same base normals."""
    m, s, C, _, _ = _params(d)
    q = avt.MeanFieldGaussian(m, s) if fam == "meanfield" else (
        avt.FullRankGaussian(m, C))
    key = jax.random.key(6)
    _, u = q.sample_with_base(key, N)
    np.testing.assert_array_equal(u, jax.random.normal(key, (N, d)))


def test_sampler_option_is_gone():
    """One sampler: the XLA path.  The option that chose another is gone."""
    with pytest.raises(TypeError):
        avt.MeanFieldGaussian(jnp.zeros(3), jnp.ones(3), sampler="xla")
    with pytest.raises(TypeError):
        avt.FullRankGaussian(jnp.zeros(3), sampler="xla")
    assert not hasattr(avt.LowRankGaussian(jnp.zeros(3), jnp.ones(3),
                                           jnp.ones((3, 1))), "sampler")


@pytest.mark.parametrize("mode", ["pallas", "Solve", ""])
def test_unknown_solve_mode_is_refused(mode):
    q = avt.FullRankGaussian(jnp.zeros(4), solve_mode=mode)
    with pytest.raises(ValueError, match="solve_mode"):
        q.log_prob(jnp.zeros((2, 4)))
    with pytest.raises(ValueError, match="solve_mode"):
        q.apply_inv_scale_T(jnp.zeros((2, 4)))
