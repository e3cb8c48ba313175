#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU, checked against the CPU.

Every phase goes through the public API (``import advancedvi_jl_tpu as avt``,
``avt.optimize``) in this one process, runs on the first GPU at the
library's default matmul precision, and is compared with the same run on the
host CPU (``jax.devices("cpu")[0]``) under
``jax.default_matmul_precision("highest")``.  Both backends draw the same
threefry base normals, and every problem is built once on the host and
copied to each device, so only the arithmetic differs.

1. flagship: hierarchical logistic regression at the reference's sonar
   shape (208 x 60 features, d = 62), mean-field ADVI + STL, 10 samples,
   Adam(1e-3), ClipScale, polynomial averaging, 5,000 steps;
2. full-rank: dense Gaussian target at d = 1024, 256 samples, full-rank
   ADVI + STL, 20 steps, at the default and at ``highest`` precision, plus
   the reference's accuracy bars at the default precision;
3. BNN: doubly-stochastic 2-layer tanh MLP (in 32, hidden 256, 16,384 rows,
   minibatch 2048, 16 samples), 200 steps;
4. measure space: natural-gradient descent and batch-and-match at d = 256.

``--multi`` runs only the four-GPU phase: the flagship, the full-rank step
with 1024 samples sharded over the "mc" mesh axis, and the tensor-, expert-
and measure-space-parallel stages, each against the same run on one GPU.

Usage::

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs of one host

Exits non-zero, printing no result, when the first JAX device is not a GPU
or any check fails.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

# Tolerances, each on max|a - b| / max|b| over the compared arrays (the
# largest difference relative to the reference's own scale).
# The GPU may run float32 matmuls in TF32 (10-bit mantissa, ~1e-3 relative
# per product) at the library's default precision; at "highest" it keeps
# full float32 and differs from the CPU only in summation order.
TOL_DEFAULT = 2e-2  # GPU default precision vs CPU highest
TOL_HIGHEST = 1e-3  # GPU highest vs CPU highest
# Sharded vs one-GPU runs share precision and draws; only the order of the
# cross-device sums differs (float32 rounding, amplified over the steps).
TOL_MULTI = 1e-3
# Reference accuracy bars (BASELINE.md): STL gradient at the optimum and
# neg-ELBO at the true posterior.
BAR_STL_GRAD = 1e-5
BAR_NEG_ELBO = 1e-2


class SmokeFailure(AssertionError):
    """A comparison or accuracy check missed its tolerance."""


def rel_diff(a, b) -> float:
    """max |a - b| / max |b| over all leaves of two matching pytrees."""
    la = [np.asarray(x, np.float64) for x in jax.tree.leaves(a)]
    lb = [np.asarray(x, np.float64) for x in jax.tree.leaves(b)]
    if len(la) != len(lb):
        raise ValueError(f"pytrees differ: {len(la)} vs {len(lb)} leaves")
    num = max(float(np.max(np.abs(x - y), initial=0.0)) for x, y in zip(la, lb))
    den = max(float(np.max(np.abs(y), initial=0.0)) for y in lb)
    return num / den if den > 0 else num


def check(label: str, err: float, tol: float, precision: str) -> None:
    """Print one comparison line; raise SmokeFailure if it misses."""
    ok = bool(np.isfinite(err)) and err <= tol
    print(
        f"  {label}: {err:.3e} (tol {tol:.0e}, {precision}) "
        f"{'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise SmokeFailure(f"{label}: {err!r} exceeds {tol!r} ({precision})")


def parse_nvidia_smi(text: str) -> list[tuple[str, float]]:
    """(name, power limit in W) per card from
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    cards = []
    for line in text.strip().splitlines():
        name, _, power = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        watts = power.strip().split()[0]
        cards.append((name.strip(), float(watts)))
    return cards


def nvidia_smi_lines() -> str:
    """The card's name and power limit, as nvidia-smi prints them (run as a
    child process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    parse_nvidia_smi(out)  # refuse output we cannot read
    return out


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": d.platform,
                "kind": d.device_kind,
                "count": len(devices),
            },
        }
    )


def require_gpu():
    """The first JAX device if it is a GPU; exit non-zero otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"{os.path.basename(sys.argv[0])}: first JAX device is "
            f"{dev.platform!r}, not a GPU; refusing to run on the CPU",
            file=sys.stderr,
        )
        sys.exit(2)
    return dev


def _precision(p):
    return contextlib.nullcontext() if p is None else jax.default_matmul_precision(p)


def _label(p) -> str:
    return "default precision" if p is None else f"{p} precision"


def run_optimize(dev, precision, make_alg, problem, steps, log_every=1,
                 mesh=None):
    """One ``avt.optimize`` run on ``dev`` at ``precision``.  ``problem`` is
    ``(key, target, q0)`` built on the host; it is copied to ``dev`` first,
    or replicated over ``mesh`` when one is given.
    Returns (alg, out, infos, state, seconds)."""
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.parallel.mesh import replicated

    place = dev if mesh is None else replicated(mesh)
    with jax.default_device(dev), _precision(precision):
        key, target, q0 = jax.device_put(problem, place)
        alg = make_alg()
        t0 = time.perf_counter()
        out, infos, state = avt.optimize(
            key, alg, steps, target, q0, log_every=log_every, mesh=mesh
        )
        jax.block_until_ready((out, state))
        return alg, out, infos, state, time.perf_counter() - t0


def time_steady(dev, precision, alg, state, steps, log_every=1, mesh=None):
    """Seconds for ``steps`` more steps from ``state``.  The first warm-start
    call may compile once more (its inputs are the previous run's outputs),
    so one untimed call comes first."""
    import advancedvi_jl_tpu as avt

    with jax.default_device(dev), _precision(precision):
        for _ in range(2):  # untimed warm-up, then the timed call
            t0 = time.perf_counter()
            out, _, state = avt.optimize(
                None, alg, steps, state.prob, None, state=state,
                log_every=log_every, mesh=mesh,
            )
            jax.block_until_ready((out, state))
        return time.perf_counter() - t0


def _elbos(infos):
    return np.asarray([float(r["elbo"]) for r in infos])


def _report_times(first_s, steady_s, steps):
    print(
        f"  first call {first_s:.2f}s (compile included), steady "
        f"{steady_s:.3f}s for {steps} steps = {steps / steady_s:.1f} steps/s "
        f"(optimize, block_until_ready), compile ~"
        f"{max(first_s - steady_s, 0.0):.2f}s",
        flush=True,
    )


def _family_arrays(q):
    return {k: v for k, v in vars(q).items() if isinstance(v, jax.Array)}


def phase_flagship(dev, ref, steps=5000, log_every=500, n_data=208,
                   n_features=60):
    import optax

    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.logreg import make_logreg

    print(f"phase flagship: logreg {n_data}x{n_features}, mean-field ADVI+STL, "
          f"n_samples=10, {steps} steps", flush=True)
    with jax.default_device(ref):
        target = make_logreg(
            jax.random.key(11), n_data=n_data, n_features=n_features
        ).unconstrained()
        d = n_features + 2
        problem = (jax.random.key(0),
                   target,
                   avt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d)))

    def make_alg():
        return avt.KLMinRepGradDescent(
            entropy=avt.STL, n_samples=10, optimizer=optax.adam(1e-3),
            operator=avt.ClipScale(), averager=avt.PolynomialAveraging(),
        )

    alg, g_out, g_infos, g_state, first = run_optimize(
        dev, None, make_alg, problem, steps, log_every)
    steady = time_steady(dev, None, alg, g_state, steps, log_every)
    _report_times(first, steady, steps)
    _, c_out, c_infos, _, _ = run_optimize(
        ref, "highest", make_alg, problem, steps, log_every)
    g_elbo, c_elbo = _elbos(g_infos), _elbos(c_infos)
    print(f"  final ELBO gpu {g_elbo[-1]:.4f} cpu {c_elbo[-1]:.4f}", flush=True)
    if not np.all(np.isfinite(g_elbo)):
        raise SmokeFailure("flagship ELBO not finite on the GPU")
    prec = "gpu default vs cpu highest"
    check("flagship location rel diff", rel_diff(g_out.location, c_out.location),
          TOL_DEFAULT, prec)
    check("flagship scale rel diff", rel_diff(g_out.scale_diag, c_out.scale_diag),
          TOL_DEFAULT, prec)
    check("flagship ELBO trace rel diff", rel_diff(g_elbo, c_elbo),
          TOL_DEFAULT, prec)


def _accuracy_bars(dev):
    """The reference's bars (BASELINE.md) at the default precision on ``dev``."""
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.normal import normal_fullrank, normal_meanfield

    with jax.default_device(dev):
        target, mu, L = normal_fullrank(jax.random.key(3), 5)
        obj = avt.RepGradELBO(n_samples=4, entropy=avt.STL)
        grad, _, _ = obj.value_and_grad(
            avt.FullRankGaussian(mu, L), target, jax.random.key(0))
        gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                                   for g in jax.tree.leaves(grad))))
        check("bar: STL gradient norm at the optimum (d=5)", gnorm,
              BAR_STL_GRAD, "gpu default")
        target, mu, L = normal_meanfield(jax.random.key(1), 5)
        obj = avt.RepGradELBO(n_samples=100_000, entropy=avt.MONTE_CARLO)
        val = float(obj.estimate_objective(
            jax.random.key(0), avt.MeanFieldGaussian(mu, jnp.diag(L)), target))
        check("bar: |neg-ELBO| at the true posterior (1e5 samples)", abs(val),
              BAR_NEG_ELBO, "gpu default")


def phase_fullrank(dev, ref, d=1024, n_samples=256, steps=20):
    import optax

    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.normal import normal_fullrank_wellcond

    print(f"phase full-rank: dense Gaussian d={d}, n_samples={n_samples}, "
          f"ADVI+STL, {steps} steps", flush=True)
    with jax.default_device(ref):
        target, _, _ = normal_fullrank_wellcond(jax.random.key(3), d)
        problem = (jax.random.key(4), target,
                   avt.FullRankGaussian(jnp.zeros(d)))

    def make_alg():
        return avt.KLMinRepGradDescent(
            entropy=avt.STL, n_samples=n_samples, optimizer=optax.adam(1e-3),
            operator=avt.ClipScale(),
        )

    _, c_out, c_infos, _, _ = run_optimize(ref, "highest", make_alg, problem, steps)
    for precision, tol in ((None, TOL_DEFAULT), ("highest", TOL_HIGHEST)):
        alg, g_out, g_infos, g_state, first = run_optimize(
            dev, precision, make_alg, problem, steps)
        steady = time_steady(dev, precision, alg, g_state, steps)
        print(f"  [{_label(precision)}] final ELBO gpu "
              f"{_elbos(g_infos)[-1]:.4f} cpu {_elbos(c_infos)[-1]:.4f}")
        _report_times(first, steady, steps)
        prec = f"gpu {_label(precision)} vs cpu highest"
        check("full-rank ELBO trace rel diff",
              rel_diff(_elbos(g_infos), _elbos(c_infos)), tol, prec)
        check("full-rank location rel diff",
              rel_diff(g_out.location, c_out.location), tol, prec)
        check("full-rank scale rel diff",
              rel_diff(jnp.tril(g_out.scale), jnp.tril(c_out.scale)), tol, prec)
    with jax.default_device(dev):
        key, target_d, q0 = jax.device_put(problem, dev)
        alg = make_alg()
        state = alg.init(key, q0, target_d)
        mem = jax.jit(alg.step).lower(state).compile().memory_analysis()
    print(f"  step memory_analysis: {mem}", flush=True)
    _accuracy_bars(dev)


def phase_bnn(dev, ref, n_data=16_384, in_dim=32, hidden=256, batch=2048,
              n_samples=16, steps=200, n_compare=10):
    import optax

    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.bnn import make_bnn

    print(f"phase BNN: MLP in={in_dim} hidden={hidden}, {n_data} rows, "
          f"minibatch {batch}, n_samples={n_samples}, {steps} steps", flush=True)
    with jax.default_device(ref):
        bnn = make_bnn(jax.random.key(1), n_data=n_data, in_dim=in_dim,
                       hidden=hidden)
        d = bnn.dim
        problem = (jax.random.key(0), bnn,
                   avt.MeanFieldGaussian(jnp.zeros(d), 0.05 * jnp.ones(d)))
    print(f"  parameters d={d}")

    def make_alg():
        return avt.KLMinRepGradDescent(
            entropy=avt.STL, n_samples=n_samples,
            subsampling=avt.ReshufflingBatchSubsampling(
                n_data=n_data, batchsize=batch),
            optimizer=optax.adam(1e-3), operator=avt.ClipScale(),
        )

    alg, _, g_infos, g_state, first = run_optimize(
        dev, None, make_alg, problem, steps)
    steady = time_steady(dev, None, alg, g_state, steps)
    _report_times(first, steady, steps)
    g_elbo = _elbos(g_infos)
    if not np.all(np.isfinite(g_elbo)):
        raise SmokeFailure("BNN ELBO not finite on the GPU")
    _, _, c_infos, _, _ = run_optimize(
        ref, "highest", make_alg, problem, n_compare)
    print(f"  ELBO step {n_compare}: gpu {g_elbo[n_compare - 1]:.2f} "
          f"cpu {_elbos(c_infos)[-1]:.2f}; step {steps}: gpu {g_elbo[-1]:.2f}")
    check(f"BNN first {n_compare} ELBOs rel diff",
          rel_diff(g_elbo[:n_compare], _elbos(c_infos)), TOL_DEFAULT,
          "gpu default vs cpu highest")


def phase_measure_space(dev, ref, d=256, steps=20, n_samples=32):
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.normal import normal_fullrank_wellcond

    with jax.default_device(ref):
        target, _, _ = normal_fullrank_wellcond(jax.random.key(5), d)
        problem = (jax.random.key(6), target,
                   avt.FullRankGaussian(jnp.zeros(d)))
    algs = {
        "KLMinNaturalGradDescent": lambda: avt.KLMinNaturalGradDescent(
            stepsize=0.05, n_samples=n_samples),
        "FisherMinBatchMatch": lambda: avt.FisherMinBatchMatch(
            n_samples=n_samples),
    }
    for name, make_alg in algs.items():
        print(f"phase measure space: {name} d={d}, n_samples={n_samples}, "
              f"{steps} steps", flush=True)
        alg, g_out, g_infos, g_state, first = run_optimize(
            dev, None, make_alg, problem, steps)
        steady = time_steady(dev, None, alg, g_state, steps)
        _report_times(first, steady, steps)
        _, c_out, c_infos, _, _ = run_optimize(
            ref, "highest", make_alg, problem, steps)
        prec = "gpu default vs cpu highest"
        check(f"{name} location rel diff",
              rel_diff(g_out.location, c_out.location), TOL_DEFAULT, prec)
        check(f"{name} scale rel diff",
              rel_diff(jnp.tril(g_out.scale), jnp.tril(c_out.scale)),
              TOL_DEFAULT, prec)


def phase_multi(devices, flagship_steps=5000, n_data=208, n_features=60,
                fr_d=1024, fr_samples=1024, fr_steps=20, small_d=16):
    """Each sharded run over the "mc" axis of a (1 x len(devices)) mesh
    against the same run on ``devices[0]`` alone."""
    import optax

    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.logreg import make_logreg
    from advancedvi_jl_tpu.models.normal import (
        normal_fullrank,
        normal_fullrank_wellcond,
    )

    mc = avt.MC_AXIS
    mesh = avt.make_vi_mesh(n_mc=len(devices), devices=devices)
    one = devices[0]
    print(f"phase multi: mesh {dict(mesh.shape)} over {len(devices)} devices",
          flush=True)
    with jax.default_device(one):
        logreg = make_logreg(jax.random.key(11), n_data=n_data,
                             n_features=n_features).unconstrained()
        d_lr = n_features + 2
        fr_target, _, _ = normal_fullrank_wellcond(jax.random.key(3), fr_d)
        small_target, _, _ = normal_fullrank(jax.random.key(5), small_d)
        cases = {
            "flagship (mc)": (
                lambda: avt.KLMinRepGradDescent(
                    entropy=avt.STL, n_samples=10, optimizer=optax.adam(1e-3),
                    operator=avt.ClipScale(),
                    averager=avt.PolynomialAveraging(), mc_axis=mc),
                (jax.random.key(0), logreg,
                 avt.MeanFieldGaussian(jnp.zeros(d_lr), 0.1 * jnp.ones(d_lr))),
                flagship_steps),
            f"full-rank d={fr_d} n={fr_samples} (mc)": (
                lambda: avt.KLMinRepGradDescent(
                    entropy=avt.STL, n_samples=fr_samples,
                    optimizer=optax.adam(1e-3), operator=avt.ClipScale(),
                    mc_axis=mc),
                (jax.random.key(4), fr_target,
                 avt.FullRankGaussian(jnp.zeros(fr_d))),
                fr_steps),
            "tensor-parallel scale rows (tp)": (
                lambda: avt.KLMinRepGradDescent(
                    entropy=avt.STL, n_samples=8, operator=avt.ClipScale(),
                    mc_axis=mc),
                (jax.random.key(1), small_target,
                 avt.FullRankGaussian(jnp.zeros(small_d)).replace(tp_axis=mc)),
                fr_steps),
            "expert-parallel mixture (ep)": (
                lambda: avt.ParamSpaceSGD(
                    objective=avt.MixtureELBO(n_samples=4, ep_axis=mc),
                    optimizer=optax.adam(1e-2), averager=avt.NoAveraging(),
                    operator=avt.ClipScale()),
                (jax.random.key(3), small_target,
                 avt.mixture_meanfield(jax.random.key(2), dim=small_d,
                                       n_components=4 * len(devices),
                                       spread=0.5)),
                fr_steps),
            "natural-gradient descent (mc)": (
                lambda: avt.KLMinNaturalGradDescent(
                    stepsize=0.05, n_samples=8, mc_axis=mc),
                (jax.random.key(4), small_target,
                 avt.FullRankGaussian(jnp.zeros(small_d))),
                fr_steps),
        }
    for name, (make_alg, problem, steps) in cases.items():
        print(f"  case {name}: {steps} steps", flush=True)
        _, s_out, s_infos, _, _ = run_optimize(
            one, None, make_alg, problem, steps)
        alg, m_out, m_infos, m_state, first = run_optimize(
            one, None, make_alg, problem, steps, mesh=mesh)
        steady = time_steady(one, None, alg, m_state, steps, mesh=mesh)
        _report_times(first, steady, steps)
        print(f"  final ELBO sharded {_elbos(m_infos)[-1]:.4f} "
              f"one device {_elbos(s_infos)[-1]:.4f}")
        check(f"{name} output rel diff",
              rel_diff(_family_arrays(m_out), _family_arrays(s_out)),
              TOL_MULTI, "sharded vs one device, default precision")
        check(f"{name} ELBO trace rel diff",
              rel_diff(_elbos(m_infos), _elbos(s_infos)),
              TOL_MULTI, "sharded vs one device, default precision")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    dev = require_gpu()
    devices = jax.devices()
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    print("card (nvidia-smi name, power.limit):", flush=True)
    print(nvidia_smi_lines(), flush=True)

    from advancedvi_jl_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    print(f"compile cache: {cache}", flush=True)

    if args.multi:
        if len(devices) != 4:
            print(f"chip_smoke --multi needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        phases = {"multi": lambda: phase_multi(devices)}
    else:
        ref = jax.devices("cpu")[0]
        phases = {
            "flagship": lambda: phase_flagship(dev, ref),
            "full-rank": lambda: phase_fullrank(dev, ref),
            "bnn": lambda: phase_bnn(dev, ref),
            "measure-space": lambda: phase_measure_space(dev, ref),
        }
    failed = []
    for name, run in phases.items():
        t0 = time.perf_counter()
        try:
            run()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {time.perf_counter() - t0:.1f}s "
              f"{'FAILED' if name in failed else 'passed'}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
