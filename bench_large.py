"""Workload measurements on one NVIDIA GPU (bench.py is the headline).

Rows, each printed as one JSON line with the device it ran on:

1. BNN posterior: mean-field ADVI+STL on a 2-layer MLP (in=32, hidden=256,
   d≈8.7k params) over 16k data points, minibatch 2048, n_samples=16, and
   Polyak-averaged proximal descent on the same posterior.
2. The XLA sampler ``sample_with_base`` at (65,536 x 512), mean-field and
   full-rank: time per call, bytes/s against the HBM peak and, for
   full-rank, FLOP/s against the TF32 and float32 peaks.
3. The full-rank STL step at d=1024/n=256 and d=2048/n=128 with
   ``solve_mode="solve"`` and ``"inverse"``.
4. The general path's steps/s and device kernels per step on the flagship
   (d=62, n=10) and for 128 and 1024 vmapped chains.
5. Full-rank normal-lognormal (d=10) and wall-clock to a target ELBO on the
   flagship.

Plus the card's own reach for context: a large copy and a large bf16 matmul.
Peaks come from ``PEAKS`` (keyed by ``device_kind``); an unknown device is
an error.  Fails when the first JAX device is not a GPU.

Run: ``python bench_large.py`` (one GPU; traces go to build/traces/).
"""

import glob
import json
import os
import shutil
import sys
import time

import jax
import jax.numpy as jnp
import optax

REPO = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks per device_kind (NVIDIA H100 SXM data sheet; the
# rates assume the full 700 W power limit): FLOP/s and HBM bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks_for(device) -> dict:
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no peak table for device_kind {device.device_kind!r}; add its "
            "data-sheet peaks to PEAKS"
        ) from None


_DEVICE = {}


def emit(row: dict) -> None:
    row["device"] = _DEVICE
    print(json.dumps(row), flush=True)


def _time_chunk(alg, state, steps, unroll=1, reps=3):
    """steps/s of ``alg.step`` under a carry-only scan, best of ``reps``."""

    def chunk(s):
        def body(c, _):
            st, _ = c
            s2, info = alg.step(st)
            return (s2, info["elbo"]), None

        (s2, el), _ = jax.lax.scan(
            body, (s, jnp.zeros(())), None, length=steps, unroll=unroll
        )
        return s2, el

    f = jax.jit(chunk)
    state, el = jax.block_until_ready(f(state))
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        state, el = jax.block_until_ready(f(state))
        best = min(best, time.perf_counter() - t0)
    last = float(el)
    if not jnp.isfinite(last):
        raise FloatingPointError(f"non-finite ELBO {last}")
    return steps / best, last, f, state


def kernels_per_step(f, state, steps, tag):
    """Per-step counts from a profiler trace of one call of the compiled
    chunk ``f`` (``steps`` steps): kernel events on the GPU's stream lines
    and their summed device time, with memory copies and sets counted
    apart (a device-to-host copy per step is a host round trip).
    Returns (kernels, kernel ns, copies, events per line), per step."""
    from jax.profiler import ProfileData

    logdir = os.path.join(REPO, "build", "traces", tag)
    shutil.rmtree(logdir, ignore_errors=True)
    with jax.profiler.trace(logdir):
        jax.block_until_ready(f(state))
    (path,) = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                        recursive=True)
    n, busy_ns, copies, lines = 0, 0, 0, {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines[line.name] = len(events)
            if not line.name.startswith("Stream"):
                continue
            for e in events:
                if e.name.lower().startswith(("memcpy", "memset")):
                    copies += 1
                    continue
                n += 1
                busy_ns += e.duration_ns
    return n / steps, busy_ns / steps, copies / steps, lines


def bench_calibration():
    """What the card reaches on a large copy and a large bf16 matmul."""
    x = jnp.ones((256 * 1024 * 1024,), jnp.float32)  # 1 GiB
    copy = jax.jit(lambda a: a * 1.0001)
    jax.block_until_ready(copy(x))
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        y = copy(x)
    jax.block_until_ready(y)
    dt = (time.perf_counter() - t0) / reps
    emit({"metric": "calibration_copy_bytes_per_s",
          "value": 2 * x.nbytes / dt, "unit": "B/s"})
    n = 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda p, q: p @ q)
    jax.block_until_ready(mm(a, a))
    t0 = time.perf_counter()
    for _ in range(reps):
        c = mm(a, a)
    jax.block_until_ready(c)
    dt = (time.perf_counter() - t0) / reps
    emit({"metric": "calibration_bf16_matmul_flops",
          "value": 2 * n**3 / dt, "unit": "FLOP/s"})


def bench_bnn():
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.bnn import make_bnn

    bnn = make_bnn(jax.random.key(1), n_data=16_384, in_dim=32, hidden=256)
    d = bnn.dim
    q0 = avt.MeanFieldGaussian(jnp.zeros(d), 0.05 * jnp.ones(d))
    sub = avt.ReshufflingBatchSubsampling(n_data=16_384, batchsize=2048)
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=16, subsampling=sub,
        optimizer=optax.adam(1e-3), operator=avt.ClipScale(),
    )
    sps, _, _, _ = _time_chunk(alg, alg.init(jax.random.key(0), q0, bnn), 200)
    emit({"metric": "bnn_8704param_steps_per_s", "value": sps,
          "unit": "steps/s"})

    # Polyak-averaged proximal descent on the same BNN posterior (DoWG step
    # size, closed-form entropy prox).
    alg_px = avt.KLMinRepGradProxDescent(
        entropy_zerograd=avt.CLOSED_FORM_ZERO_GRAD, n_samples=16,
        subsampling=sub, optimizer=avt.dowg(),
        averager=avt.PolynomialAveraging(),
    )
    sps_px, elbo_px, _, _ = _time_chunk(
        alg_px, alg_px.init(jax.random.key(0), q0, bnn), 200)
    emit({"metric": "bnn_8704param_proxdescent_steps_per_s", "value": sps_px,
          "unit": "steps/s", "elbo_after_chunks": elbo_px})


def bench_sampler(n=65_536, d=512, reps=50):
    """``sample_with_base`` as XLA compiles it: mean-field is one elementwise
    fusion (threefry, normal transform, affine map); full-rank adds the
    (n, d) x (d, d) GEMM.  Bytes are the algorithmic minimum: z and u
    written once (parameters are negligible).  Wall time is per call over
    ``reps`` calls in flight; kernel time is from a trace of one call.
    The mean-field row is repeated with an ``rbg`` key (XLA's
    RngBitGenerator) beside the default threefry key."""
    import advancedvi_jl_tpu as avt

    pk = peaks_for(jax.devices()[0])
    loc = jnp.zeros(d)
    fams = {
        "meanfield": avt.MeanFieldGaussian(loc, jnp.ones(d)),
        "fullrank": avt.FullRankGaussian(
            loc, jnp.eye(d) + 0.01 * jnp.tril(jnp.ones((d, d)), -1)),
        "meanfield_rbg": avt.MeanFieldGaussian(loc, jnp.ones(d)),
    }
    for name, q in fams.items():
        impl = "rbg" if name.endswith("rbg") else None
        f = jax.jit(lambda k, q: q.sample_with_base(k, n))
        keys = jax.random.split(jax.random.key(0, impl=impl), reps)
        jax.block_until_ready(f(keys[0], q))
        t0 = time.perf_counter()
        for i in range(reps):
            out = f(keys[i], q)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        kernels, kernel_ns, _, _ = kernels_per_step(
            lambda k: f(k, q), keys[1], 1, f"sampler_{name}")
        kt = kernel_ns * 1e-9
        nbytes = 2 * n * d * 4
        row = {"metric": f"sampler_{name}_n{n}_d{d}_seconds", "value": dt,
               "unit": "s", "kernel_seconds": kt, "kernels": kernels,
               "bytes_per_s": nbytes / dt,
               "hbm_share": nbytes / dt / pk["hbm_bytes_per_s"],
               "hbm_share_kernel_time": (
                   nbytes / kt / pk["hbm_bytes_per_s"] if kt else None)}
        if name == "fullrank":
            flops = 2 * n * d * d
            row.update(flops_per_s=flops / dt,
                       tf32_share=flops / dt / pk["tf32_flops"],
                       fp32_share=flops / dt / pk["fp32_flops"])
        emit(row)


def bench_fullrank_solve_modes():
    """Full-rank ADVI+STL step with the STL solve as XLA's triangular solve
    (cuBLAS trsm) or as the blocked inverse plus a matmul (ops/trinv.py)."""
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.normal import normal_fullrank_wellcond

    for d, n in ((1024, 256), (2048, 128)):
        target, _, _ = normal_fullrank_wellcond(jax.random.key(3), d)
        for mode in ("solve", "inverse"):
            q0 = avt.FullRankGaussian(jnp.zeros(d), solve_mode=mode)
            alg = avt.KLMinRepGradDescent(
                entropy=avt.STL, n_samples=n, optimizer=optax.adam(1e-3),
                operator=avt.ClipScale(),
            )
            state = alg.init(jax.random.key(0), q0, target)
            sps, elbo, _, _ = _time_chunk(alg, state, 100)
            emit({"metric": f"fullrank_d{d}_n{n}_{mode}_step_seconds",
                  "value": 1.0 / sps, "unit": "s", "elbo_after": elbo})


def _flagship_alg_and_target():
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.logreg import make_logreg

    target = make_logreg(
        jax.random.key(11), n_data=208, n_features=60
    ).unconstrained()
    q0 = avt.MeanFieldGaussian(jnp.zeros(62), 0.1 * jnp.ones(62))
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=10, optimizer=optax.adam(1e-3),
        operator=avt.ClipScale(),
    )
    return alg, target, q0


def bench_flagship_general(steps=20_000):
    """The flagship step two ways: ``alg.step`` under a carry-only scan
    (unroll 8), and ``avt.optimize`` as a user calls it (per-step
    divergence check, one info row per chunk)."""
    import advancedvi_jl_tpu as avt

    alg, target, q0 = _flagship_alg_and_target()
    state = alg.init(jax.random.key(0), q0, target)
    sps, elbo, f, state = _time_chunk(alg, state, steps, unroll=8)
    kps, busy_ns, cps, lines = kernels_per_step(f, state, steps, "flagship")
    emit({"metric": "flagship_scan_steps_per_s", "value": sps,
          "unit": "steps/s", "kernels_per_step": kps,
          "copies_per_step": cps, "kernel_busy_us_per_step": busy_ns / 1e3,
          "step_us": 1e6 / sps, "elbo": elbo, "trace_lines": lines})

    def run(st):
        return avt.optimize(None, alg, steps, target, None, state=st,
                            log_every=steps)[2]

    _, _, st = avt.optimize(jax.random.key(0), alg, steps, target, q0,
                            log_every=steps)
    for _ in range(2):  # the first warm start may compile once more
        st = jax.block_until_ready(run(st))
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        st = jax.block_until_ready(run(st))
        best = min(best, time.perf_counter() - t0)
    kps, busy_ns, cps, _ = kernels_per_step(run, st, steps, "flagship_opt")
    emit({"metric": "flagship_optimize_steps_per_s", "value": steps / best,
          "unit": "steps/s", "kernels_per_step": kps,
          "copies_per_step": cps, "kernel_busy_us_per_step": busy_ns / 1e3,
          "step_us": 1e6 * best / steps})


def bench_chains(n_chains=(128, 1024), steps=500):
    from advancedvi_jl_tpu.parallel.chains import init_chains, step_chains

    alg, target, q0 = _flagship_alg_and_target()
    for K in n_chains:
        states, axes = init_chains(
            jax.random.key(0), alg, q0, target, n_chains=K, jitter=0.1
        )

        def chunk(s):
            def body(c, _):
                s2, info = step_chains(alg, c, axes)
                return s2, info["elbo"][0]

            return jax.lax.scan(body, s, None, length=steps, unroll=2)

        f = jax.jit(chunk)
        states, _ = jax.block_until_ready(f(states))
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            states, _ = jax.block_until_ready(f(states))
            best = min(best, time.perf_counter() - t0)
        kps, busy_ns, cps, _ = kernels_per_step(
            lambda s: f(s)[0], states, steps, f"chains{K}")
        emit({"metric": f"flagship_{K}chains_chainsteps_per_s",
              "value": steps * K / best, "unit": "chain-steps/s",
              "steps_per_s": steps / best, "kernels_per_step": kps,
              "copies_per_step": cps,
              "kernel_busy_us_per_step": busy_ns / 1e3})


def bench_normallognormal_fullrank():
    """Full-rank Gaussian on the normal-lognormal model with
    bijector-constrained support (Exp on the lognormal block)."""
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.normallognormal import make_normallognormal

    model, _, _ = make_normallognormal(jax.random.key(8), 10)
    q0 = avt.FullRankGaussian(jnp.zeros(model.dim))
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=10, optimizer=optax.adam(1e-3),
        operator=avt.ClipScale(),
    )
    state = alg.init(jax.random.key(0), q0, model.unconstrained())
    sps, _, _, _ = _time_chunk(alg, state, 2000, unroll=8)
    emit({"metric": "normallognormal_d10_fullrank_stl_steps_per_s",
          "value": sps, "unit": "steps/s"})


def bench_time_to_target_elbo():
    """Wall-clock to a target ELBO on the flagship logreg model (target =
    within 1 nat of the converged ELBO)."""
    import advancedvi_jl_tpu as avt
    from advancedvi_jl_tpu.models.logreg import make_logreg

    target = make_logreg(
        jax.random.key(11), n_data=208, n_features=60
    ).unconstrained()
    q0 = avt.MeanFieldGaussian(jnp.zeros(62), 0.1 * jnp.ones(62))
    alg = avt.KLMinRepGradDescent(
        entropy=avt.STL, n_samples=10, optimizer=optax.adam(1e-2),
        operator=avt.ClipScale(),
    )
    TARGET_ELBO = -104.0  # converged ~-103 on this model/seed
    CHUNK = 200

    def chunk(s):
        def body(c, _):
            s2, info = alg.step(c)
            return s2, info["elbo"]

        return jax.lax.scan(body, s, None, length=CHUNK, unroll=4)

    f = jax.jit(chunk)
    jax.block_until_ready(f(alg.init(jax.random.key(0), q0, target)))

    state = alg.init(jax.random.key(1), q0, target)
    t0 = time.perf_counter()
    steps = 0
    reached = None
    while steps < 100_000:
        state, el = f(state)
        steps += CHUNK
        if float(el[-1]) >= TARGET_ELBO:
            reached = time.perf_counter() - t0
            break
    emit({"metric": "wallclock_to_target_elbo_logreg", "value": reached,
          "unit": "s", "target_elbo": TARGET_ELBO, "steps": steps})


def main():
    from advancedvi_jl_tpu.utils.compile_cache import enable_compile_cache
    from chip_smoke import nvidia_smi_lines, require_gpu

    dev = require_gpu()
    peaks_for(dev)
    _DEVICE.update(platform=dev.platform, kind=dev.device_kind,
                   count=len(jax.devices()),
                   card=nvidia_smi_lines().splitlines()[0])

    enable_compile_cache(REPO)
    print(f"device: {_DEVICE}", file=sys.stderr)
    bench_calibration()
    bench_sampler()
    bench_fullrank_solve_modes()
    bench_flagship_general()
    bench_chains()
    bench_bnn()
    bench_normallognormal_fullrank()
    bench_time_to_target_elbo()


if __name__ == "__main__":
    main()
