"""Native-component tests: the C++ reshuffle/data engine and the CPU
XLA-FFI triangular solve (schedules, gradients, build and error paths)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import advancedvi_jl_tpu as avt
from advancedvi_jl_tpu.utils.data import (
    HostDataLoader,
    fill_permutation,
    gather_rows,
    native_available,
)


def test_native_lib_compiles():
    assert native_available(), "C++ reshuffle library failed to build"


def test_permutation_properties():
    p = fill_permutation(7, 1000)
    assert sorted(p.tolist()) == list(range(1000))
    np.testing.assert_array_equal(p, fill_permutation(7, 1000))
    assert not np.array_equal(p, fill_permutation(8, 1000))


def test_gather_matches_numpy():
    X = np.random.default_rng(0).normal(size=(5000, 64)).astype(np.float32)
    idx = fill_permutation(3, 5000)[:2048]
    np.testing.assert_array_equal(gather_rows(X, idx), X[idx])


def test_host_data_loader_schedule():
    X = np.arange(100 * 4, dtype=np.float32).reshape(100, 4)
    y = np.arange(100, dtype=np.float32)
    dl = HostDataLoader(X, y, batchsize=16, seed=5)
    assert len(dl) == 6
    seen = []
    for _ in range(len(dl)):
        Xb, yb, idx = dl.next_batch()
        assert Xb.shape == (16, 4)
        np.testing.assert_array_equal(Xb, X[idx])
        np.testing.assert_array_equal(yb[:, 0], y[idx])
        seen.extend(idx.tolist())
    assert len(set(seen)) == len(seen)
    assert dl.epoch == 1  # reshuffled for next epoch


def test_host_loader_feeds_optimize_end_to_end(key):
    """Streaming pattern for beyond-HBM datasets: the C++ host loader draws
    epoch-reshuffled minibatches in native threads; each batch is device_put
    and swapped into the (static-shape) state via state.replace(prob=...) —
    no retracing, warm state across batches. Converges to the analytic
    Bayesian-linear-regression posterior mean."""
    import optax

    rng = np.random.default_rng(3)
    n, d, b = 4096, 8, 512
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d,)).astype(np.float32)
    y = (X @ w_true + 0.1 * rng.normal(size=(n,))).astype(np.float32)

    # analytic posterior mean: (X^T X / s^2 + I)^-1 X^T y / s^2, s = 0.1
    s2 = 0.01
    post_mean = np.linalg.solve(X.T @ X / s2 + np.eye(d), X.T @ y / s2)

    def logprior(theta):
        return jnp.sum(-0.5 * jnp.square(theta))

    def loglike(theta, data):
        Xb, yb = data
        resid = yb - Xb @ theta
        return jnp.sum(-0.5 * jnp.square(resid) / s2)

    template = avt.factorized_target(
        logprior, loglike, data=(jnp.asarray(X), jnp.asarray(y)), dim=d
    ).subsample(jnp.arange(b))  # static minibatch shape

    q0 = avt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d))
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=8,
        optimizer=optax.adam(2e-2), operator=avt.ClipScale(),
    )
    state = alg.init(key, q0, template)
    step = jax.jit(alg.step)

    dl = HostDataLoader(X, y, batchsize=b, seed=11)
    likeadj = jnp.asarray(n / b, jnp.float32)
    from advancedvi_jl_tpu.utils.profiling import retrace_guard

    state, _ = step(state)  # warmup trace
    with retrace_guard(step):
        for _ in range(1200):
            Xb, yb, idx = dl.next_batch()
            prob = template.replace(
                data=(jnp.asarray(Xb), jnp.asarray(yb[:, 0])),
                likeadj=likeadj,
            )
            state = state.replace(prob=prob)
            state, info = step(state)
    assert np.isfinite(float(info["elbo"]))
    out = alg.output(state)
    err = np.linalg.norm(np.asarray(out.location) - post_mean)
    assert err < 0.15 * np.linalg.norm(post_mean), err


class TestFfiTrisolve:
    """C++ XLA-FFI custom call (ops/cpp/ffi_trisolve.cc): the native batched
    triangular solve registered with the CPU backend via jax.ffi
    (SURVEY §2.8.2/§2.8.4; reference hot path location_scale.jl:59-63)."""

    def _problem(self, d, n, dtype=np.float32, seed=0):
        rng = np.random.default_rng(seed)
        L = np.tril(rng.normal(size=(d, d)).astype(dtype)) + 3 * np.eye(
            d, dtype=dtype
        )
        B = rng.normal(size=(d, n)).astype(dtype)
        return jnp.asarray(L), jnp.asarray(B)

    def test_ffi_kernel_compiles_and_registers(self):
        from advancedvi_jl_tpu.ops.native_ffi import ffi_available

        assert ffi_available(), "FFI trisolve failed to build/register"

    @pytest.mark.parametrize("trans", [False, True])
    @pytest.mark.parametrize("d,n", [(3, 7), (64, 500), (257, 1000)])
    def test_matches_xla_triangular_solve(self, d, n, trans):
        from advancedvi_jl_tpu.ops.native_ffi import trisolve

        L, B = self._problem(d, n)
        X = trisolve(L, B, trans=trans)
        ref = jax.scipy.linalg.solve_triangular(
            L, B, lower=True, trans=1 if trans else 0
        )
        np.testing.assert_allclose(
            np.asarray(X), np.asarray(ref),
            atol=2e-4 * float(jnp.abs(ref).max()),
        )

    @pytest.mark.parametrize("trans", [False, True])
    def test_gradients_match_xla(self, trans):
        from advancedvi_jl_tpu.ops.native_ffi import trisolve

        L, B = self._problem(48, 96, seed=1)

        def f_native(L, B):
            return jnp.sum(jnp.sin(trisolve(L, B, trans=trans)))

        def f_xla(L, B):
            return jnp.sum(jnp.sin(jax.scipy.linalg.solve_triangular(
                L, B, lower=True, trans=1 if trans else 0
            )))

        gL, gB = jax.grad(f_native, argnums=(0, 1))(L, B)
        hL, hB = jax.grad(f_xla, argnums=(0, 1))(L, B)
        scale = float(jnp.abs(hL).max())
        np.testing.assert_allclose(
            np.asarray(jnp.tril(gL)), np.asarray(jnp.tril(hL)),
            atol=3e-5 * scale,
        )
        np.testing.assert_allclose(
            np.asarray(gB), np.asarray(hB),
            atol=3e-5 * float(jnp.abs(hB).max()),
        )

    def test_jit_and_upper_triangle_ignored(self):
        from advancedvi_jl_tpu.ops.native_ffi import trisolve

        L, B = self._problem(16, 32)
        # garbage in the (inert) upper triangle must not change the result
        L_dirty = L + jnp.triu(jnp.full((16, 16), 7.0), k=1)
        f = jax.jit(lambda l, b: trisolve(l, b))
        np.testing.assert_array_equal(
            np.asarray(f(L, B)), np.asarray(f(L_dirty, B))
        )

    def test_float64(self):
        """f64 kernel path, in a subprocess — a global jax_enable_x64 flip
        would invalidate jit caches for every other test in the process
        (ADVICE r2)."""
        import subprocess
        import sys

        script = """
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from advancedvi_jl_tpu.ops.native_ffi import trisolve

rng = np.random.default_rng(2)
L = np.tril(rng.normal(size=(32, 32))) + 3 * np.eye(32)
B = rng.normal(size=(32, 64))
X = trisolve(jnp.asarray(L), jnp.asarray(B))
ref = jax.scipy.linalg.solve_triangular(jnp.asarray(L), jnp.asarray(B),
                                        lower=True)
np.testing.assert_allclose(np.asarray(X), np.asarray(ref),
                           rtol=1e-12, atol=1e-12)
print("f64 trisolve OK")
"""
        r = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "f64 trisolve OK" in r.stdout

    def test_error_paths(self):
        from advancedvi_jl_tpu.ops.native_ffi import trisolve

        L, B = self._problem(8, 4)
        with pytest.raises(ValueError, match="shape mismatch"):
            trisolve(L, jnp.zeros((9, 4)))
        with pytest.raises(ValueError, match="expected L"):
            trisolve(jnp.zeros((8, 4)), B)
        with pytest.raises(TypeError, match="f32/f64"):
            trisolve(L.astype(jnp.bfloat16), B.astype(jnp.bfloat16))


def test_prefetching_loader_matches_plain(key):
    """Prefetch thread + device staging preserves the exact batch sequence."""
    import numpy as np

    from advancedvi_jl_tpu.utils.data import PrefetchingLoader

    rng = np.random.default_rng(3)
    X = rng.standard_normal((64, 4)).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)

    plain = HostDataLoader(X, y, batchsize=16, seed=5)
    with PrefetchingLoader(HostDataLoader(X, y, batchsize=16, seed=5)) as pf:
        for _ in range(9):  # across an epoch boundary
            Xb1, yb1, idx1 = plain.next_batch()
            Xb2, yb2, idx2 = pf.next_batch()
            np.testing.assert_array_equal(idx1, idx2)
            np.testing.assert_array_equal(Xb1, np.asarray(Xb2))
            np.testing.assert_array_equal(yb1, np.asarray(yb2))


def test_optimize_streamed_end_to_end(key):
    """Host-streamed subsampled ADVI through the native gather engine
    converges to the conjugate posterior: the full beyond-HBM training path
    (C++ gathers -> prefetch thread -> device staging -> one jitted step)."""
    import jax.numpy as jnp
    import numpy as np
    import optax

    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.core.factorized import factorized_target
    from advancedvi_jl_tpu.utils.data import PrefetchingLoader

    import dataclasses

    N, B = 256, 32
    rng = np.random.default_rng(7)
    y = (1.5 + rng.standard_normal(N)).astype(np.float32)

    prob = factorized_target(
        logprior_fn=lambda th: -0.5 * jnp.sum(jnp.square(th)),
        loglike_fn=lambda th, d: jnp.sum(
            -0.5 * jnp.square(d["y"][:, 0] - th[0])
        ),
        data={"y": jnp.zeros((B, 1))},  # batch-shaped staging data
        dim=1,
    )
    prob = dataclasses.replace(prob, likeadj=jnp.asarray(N / B, jnp.float32))

    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=8, optimizer=optax.adam(1e-2),
        operator=avt.ClipScale(),
    )
    q0 = avt.MeanFieldGaussian(jnp.zeros(1), jnp.ones(1))
    # X unused by this model; the loader requires one -> pass zeros as X
    with PrefetchingLoader(HostDataLoader(
        np.zeros((N, 1), np.float32), y, batchsize=B, seed=0
    )) as loader:
        q, infos, state = avt.optimize_streamed(
            key, alg, 2000, prob,
            place_batch=lambda p, Xb, yb: dataclasses.replace(
                p, data={"y": yb}
            ),
            loader=loader, q_init=q0,
        )

    post_mean = float(np.sum(y) / (N + 1))
    post_sd = (1.0 / (N + 1)) ** 0.5
    assert abs(float(q.location[0]) - post_mean) < 0.05
    np.testing.assert_allclose(float(q.scale_diag[0]), post_sd, rtol=0.25)
    assert infos[-1]["iteration"] == 2000


def test_library_solves_route_through_ffi(key):
    """On the CPU backend (no mesh) the full-rank log_prob and
    apply_inv_scale_T lower to the native FFI custom call; under a mesh they
    stay on XLA's partitionable triangular_solve (ADVICE r2: the kernel must
    be reachable from the library, not only from tests)."""
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.ops.native_ffi import ffi_available

    assert ffi_available()
    d, n = 16, 8
    q = avt.FullRankGaussian(jnp.zeros(d), jnp.eye(d) * 0.5)
    z = q.sample(key, n)

    hlo = jax.jit(q.log_prob).lower(z).as_text()
    assert "advi_trisolve_f32" in hlo
    hlo2 = jax.jit(q.apply_inv_scale_T).lower(z).as_text()
    assert "advi_trisolve_f32" in hlo2

    # Same value and gradient as the XLA path.
    ref = jax.scipy.linalg.solve_triangular(
        jnp.tril(q.scale), (z - q.location).T, lower=True
    ).T
    lp_ref = jnp.sum(
        -0.5 * ref**2 - 0.5 * np.log(2 * np.pi), axis=-1
    ) - jnp.sum(jnp.log(jnp.diag(q.scale)))
    np.testing.assert_allclose(
        np.asarray(q.log_prob(z)), np.asarray(lp_ref), rtol=1e-5
    )

    def mean_lp(qq):
        return jnp.mean(qq.log_prob(z))

    g = jax.grad(mean_lp)(q)

    def mean_lp_xla(qq):
        u = jax.scipy.linalg.solve_triangular(
            jnp.tril(qq.scale), (z - qq.location).T, lower=True
        ).T
        return jnp.mean(
            jnp.sum(-0.5 * u**2 - 0.5 * np.log(2 * np.pi), axis=-1)
            - jnp.sum(jnp.log(jnp.abs(jnp.diag(qq.scale))))
        )

    g_ref = jax.grad(mean_lp_xla)(q)
    np.testing.assert_allclose(
        np.asarray(g.location), np.asarray(g_ref.location), rtol=1e-4,
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(jnp.tril(g.scale)), np.asarray(jnp.tril(g_ref.scale)),
        rtol=1e-4, atol=1e-6,
    )

    # Under a mesh: XLA path (custom calls are not partitionable).
    from advancedvi_jl_tpu.parallel.mesh import make_vi_mesh

    mesh = make_vi_mesh()
    with jax.set_mesh(mesh):
        hlo_mesh = jax.jit(q.log_prob).lower(z).as_text()
    assert "advi_trisolve_f32" not in hlo_mesh
