"""The `optimize` driver loop.

Redesign of the reference driver (reference: src/optimize.jl:42-94).
The reference runs a host loop calling a dynamically-dispatched `step`; here
the step is compiled once and driven either

- in **scan mode** (default): `lax.scan` over chunks of iterations — the host
  syncs only once per chunk, so tiny VI models run at device speed instead of
  host-dispatch speed (the main perf design decision, SURVEY.md §7); or
- in **callback mode**: a host loop around the jitted step, used when a
  per-iteration Python callback is supplied (host sync per step, same
  semantics as the reference's callback contract, common.jl:106-118).

Per-iteration ``info`` dicts come back as stacked device arrays (scan mode)
and are converted to a list of dicts for reference parity.  Warm-starting via
``state=`` reproduces the reference's split-run == single-run invariant
(test/general/optimize.jl:30-41) because the PRNG key and iteration counter
live in the state.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Optional

import jax


class DivergenceError(RuntimeError):
    """Raised when the objective became non-finite (reference: common.jl:83-89)."""


# Compiled-step cache keyed on the algorithm object: repeated optimize()
# calls with the same algorithm (warm-start segments, periodic evaluation
# loops) reuse the jitted scan instead of recompiling.  WeakKey so dropping
# the algorithm frees the executables.
_JIT_CACHE: "weakref.WeakKeyDictionary[Any, dict]" = weakref.WeakKeyDictionary()


def _cached_jit(algorithm, kind: str, make):
    try:
        per_alg = _JIT_CACHE.setdefault(algorithm, {})
    except TypeError:  # unhashable/non-weakrefable algorithm
        return make()
    if kind not in per_alg:
        per_alg[kind] = make()
    return per_alg[kind]


def _steps_grouped(
    alg, state, n_groups: int, group: int, start_it,
    unroll: int = 1, check_divergence: bool = True,
):
    """Nested scan recording one info row per ``group`` steps.

    Host memory stays O(n_groups) instead of O(n_groups * group) — the
    scalable path for 10^6-iteration runs (the reference streams to a
    progress meter instead of materializing, optimize.jl:64-78; here the
    device loop keeps only each group's last info).

    Early exit on two channels:

    - **divergence** (only when the driver will raise on it, i.e.
      ``check_divergence=True``): once a step reports ``diverged``, every
      later step is skipped via ``lax.cond`` (the skip branch just forwards
      the carry, so the rest of the scan is ~free) and the exact first bad
      iteration is returned for the host-side raise.  With
      ``check_divergence=False`` a NaN objective does not halt — a user who
      disabled divergence checking to push through transient non-finite
      objectives keeps optimizing.
    - **termination**: an algorithm whose ``step`` emits a boolean
      ``info["terminate"]`` stops the loop at that exact step (the
      reference's ``(state, terminate, info)`` protocol,
      src/optimize.jl:67-74); the first terminating iteration is returned.

    Returns ``(state, stacked_infos, first_div, first_term)`` with the
    iteration indices 0 when the corresponding event never fired.  When
    neither channel can fire (no divergence checking and the algorithm's
    info carries no ``terminate`` key) the per-step ``lax.cond`` is elided
    entirely.
    """
    import jax.numpy as jnp

    _, info_shape = jax.eval_shape(alg.step, state)
    has_div = check_divergence and "diverged" in info_shape
    has_term = "terminate" in info_shape
    early_exit = has_div or has_term
    info0 = jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), info_shape
    )
    t0 = jnp.asarray(start_it, jnp.int64 if jax.config.jax_enable_x64
                     else jnp.int32)
    false = jnp.asarray(False)

    def body(carry, _):
        st, info_prev, halted, first_div, first_term, t = carry

        if early_exit:
            def do(args):
                st, _ = args
                return alg.step(st)

            def skip(args):
                return args

            st_new, info = jax.lax.cond(halted, skip, do, (st, info_prev))
        else:
            st_new, info = alg.step(st)
        div = info.get("diverged", false) if has_div else false
        term = info.get("terminate", false) if has_term else false
        fresh = ~halted
        first_div = jnp.where(fresh & div, t + 1, first_div)
        # Divergence wins over a simultaneous terminate: the raise must fire.
        first_term = jnp.where(fresh & term & ~div, t + 1, first_term)
        return (st_new, info, halted | div | term,
                first_div, first_term, t + 1), None

    def outer(carry, _):
        carry, _ = jax.lax.scan(body, carry, None, length=group,
                                unroll=unroll)
        return carry, carry[1]  # last info of the group

    init = (state, info0, false, jnp.zeros_like(t0), jnp.zeros_like(t0), t0)
    (state, _, _, first_div, first_term, _), infos = jax.lax.scan(
        outer, init, None, length=n_groups
    )
    return state, infos, first_div, first_term


def optimize(
    key: jax.Array,
    algorithm,
    max_iter: int,
    prob,
    q_init,
    *,
    state: Optional[Any] = None,
    callback: Optional[Callable] = None,
    chunk_size: Optional[int] = None,
    show_progress: bool = False,
    progress: Optional[Any] = None,
    check_divergence: bool = True,
    mesh: Optional[Any] = None,
    unroll: int = 1,
    log_every: int = 1,
):
    """Run a variational inference algorithm.

    Returns ``(output, info, state)`` exactly like the reference
    (output distribution, list of per-iteration info dicts, warm-start state).

    ``mesh``: optional ``jax.sharding.Mesh`` (see parallel.make_vi_mesh); the
    whole run executes under it with state replicated and the MC/data axes
    sharded per the objective's ``mc_axis`` / the target's ``data_axis``
    annotations.

    ``log_every``: record one info row per ``log_every`` iterations (the last
    of each group).  With the default 1 every iteration is recorded, like the
    reference.  For long runs (10^5+ iterations) a larger value keeps host
    memory flat — the thinning happens ON DEVICE (scan mode), divergence is
    still detected at the exact offending step, and all later steps are
    skipped at ~zero cost.

    ``show_progress`` / ``progress``: live single-line display of the merged
    per-iteration info (elbo + algorithm extras + callback extras), matching
    the reference's ProgressMeter UX (src/utils.jl:2-4, src/optimize.jl:52-54).
    ``progress`` takes a preconfigured ``utils.progress.ProgressMeter``
    (custom stream/throttle; implies show_progress).  In scan mode the
    display updates once per device chunk — with no explicit ``chunk_size``
    the driver picks ~20 chunks so the bar moves while the device loop runs.
    """
    if log_every < 1:
        raise ValueError(f"log_every must be >= 1, got {log_every}")
    if progress is not None:
        show_progress = True
    if show_progress and progress is None:
        from .utils.progress import ProgressMeter

        progress = ProgressMeter(max_iter)
    if (
        show_progress
        and callback is None
        and chunk_size is None
        and max_iter >= 40
    ):
        # scan mode syncs the host once per chunk; pick ~20 chunks so the
        # meter actually moves (one extra compile at most: the remainder)
        chunk_size = -(-max_iter // 20)
    if mesh is not None:
        from .parallel.mesh import replicate_state

        with jax.set_mesh(mesh):
            if state is None:
                state = algorithm.init(key, q_init, prob)
            state = replicate_state(state, mesh)
            return _optimize_loop(
                algorithm, max_iter, state, callback, chunk_size,
                progress, check_divergence, unroll, log_every,
            )
    if state is None:
        state = algorithm.init(key, q_init, prob)
    return _optimize_loop(
        algorithm, max_iter, state, callback, chunk_size,
        progress, check_divergence, unroll, log_every,
    )


def _accepted_kwargs(callback: Callable) -> Optional[set]:
    """Parameter names a callback accepts, or None if it takes **kwargs."""
    import inspect

    try:
        sig = inspect.signature(callback)
    except (TypeError, ValueError):
        return None
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            return None
    return set(sig.parameters)


def _optimize_loop(
    algorithm,
    max_iter: int,
    state: Any,
    callback: Optional[Callable],
    chunk_size: Optional[int],
    progress: Optional[Any],
    check_divergence: bool,
    unroll: int = 1,
    log_every: int = 1,
):

    infos: list = []

    if callback is not None:
        # Host loop: jitted single step + Python callback per iteration.
        # Callback payload parity with the reference (common.jl:106-118):
        # beyond (iteration, state, info), callbacks that declare them also
        # receive ``gradient`` (the raw gradient pytree of this step — the
        # algorithm's step must support ``with_grad``, ParamSpaceSGD does)
        # and ``averaged_params`` (the averaged-iterate family).  ``params``
        # needs no separate channel: the family pytree IS the parameter
        # vector (state.q).  A callback may stop the loop by returning
        # {"terminate": True}; an algorithm by emitting info["terminate"].
        accepted = _accepted_kwargs(callback)

        def wants(name: str) -> bool:
            return accepted is None or name in accepted

        with_grad = wants("gradient") and getattr(
            algorithm, "supports_grad", False
        )
        if with_grad:
            step_fn = _cached_jit(
                algorithm, "step_grad",
                lambda: jax.jit(lambda s: algorithm.step(s, with_grad=True)),
            )
        else:
            step_fn = _cached_jit(
                algorithm, "step", lambda: jax.jit(algorithm.step)
            )
        for t in range(max_iter):
            state, info = step_fn(state)
            gradient = info.pop("gradient", None)
            info = {k: jax.device_get(v) for k, v in info.items()}
            if check_divergence and bool(info.get("diverged", False)):
                raise DivergenceError(
                    f"The objective value is {info.get('elbo')} at iteration "
                    f"{t + 1}. This indicates that the optimization diverged."
                )
            kw = dict(
                iteration=int(jax.device_get(state.iteration)),
                state=state,
                info=info,
            )
            if with_grad:
                kw["gradient"] = gradient
            if wants("averaged_params"):
                kw["averaged_params"] = algorithm.output(state)
            if accepted is not None:
                kw = {k: v for k, v in kw.items() if k in accepted}
            extra = callback(**kw)
            stop = bool(info.get("terminate", False))
            if extra:
                stop = stop or bool(extra.pop("terminate", False))
                info.update(extra)
            info["iteration"] = t + 1
            if (t + 1) % log_every == 0 or t + 1 == max_iter or stop:
                infos.append(info)
            if progress is not None:
                progress.update(t + 1, info, force=stop)
            if stop:
                break
        if progress is not None:
            progress.close()
    else:
        # Device-side loop, unified across log_every (VERDICT r2 #6): a
        # nested scan records one info row per ``log_every`` steps
        # (log_every=1 is just group=1) and — when divergence checking or
        # algorithm-driven termination is live — skips every step after the
        # first halting one via lax.cond, so a NaN at step k costs O(k)
        # wall-clock in every mode and the host raise names the exact
        # iteration.  Chunks are normalized to a multiple of log_every so
        # recorded iterations stay on the log_every grid and only the final
        # max_iter-remainder group (if any) compiles a second program.
        chunk = chunk_size or max_iter
        chunk = max(log_every, (chunk // log_every) * log_every)
        done = 0
        terminated = False
        while done < max_iter and not terminated:
            n = min(chunk, max_iter - done)
            groups = [(n // log_every, log_every)]
            if n % log_every:
                groups.append((1, n % log_every))
            for n_groups, group in groups:
                if n_groups == 0:
                    continue
                fn = _cached_jit(
                    algorithm,
                    f"grouped_{n_groups}_{group}_{unroll}_{check_divergence}",
                    lambda: jax.jit(
                        lambda s, t0: _steps_grouped(
                            algorithm, s, n_groups, group, t0,
                            unroll=unroll, check_divergence=check_divergence,
                        )
                    ),
                )
                state, stacked, first_div, first_term = fn(state, done)
                stacked = jax.device_get(stacked)
                first_div = int(jax.device_get(first_div))
                first_term = int(jax.device_get(first_term))
                if check_divergence and first_div:
                    raise DivergenceError(
                        "The objective became non-finite at iteration "
                        f"{first_div}. This indicates that the optimization "
                        "diverged."
                    )
                last_g = n_groups - 1
                if first_term:
                    # Keep rows up to the group containing the terminating
                    # step; later rows are forwarded copies of it.
                    last_g = (first_term - done - 1) // group
                    terminated = True
                for g in range(last_g + 1):
                    row = {k: v[g] for k, v in stacked.items()}
                    row["iteration"] = done + (g + 1) * group
                    infos.append(row)
                if first_term:
                    infos[-1]["iteration"] = first_term
                done += n_groups * group
                if terminated:
                    break
            if progress is not None and infos:
                progress.update(
                    min(done, max_iter), infos[-1], force=terminated
                )
        if progress is not None:
            progress.close()

    return algorithm.output(state), infos, state
