"""Tracing / profiling / correctness-guard subsystem.

The reference's observability is the per-iteration info NamedTuple on a
progress bar (reference: src/optimize.jl:65-77, src/utils.jl:2-4).  The
additions here (SURVEY.md §5):

- ``trace(logdir)``: context manager around ``jax.profiler`` — produces a
  TensorBoard-loadable device trace of the jitted step.
- ``retrace_guard``: asserts a jitted function does NOT recompile after
  warmup — the analogue of the reference's stale-prepared-tape guards
  (its rejection of compiled ReverseDiff tapes, src/AdvancedVI.jl:87-98):
  silent retracing is the way shape bugs show up as 100x slowdowns.
- ``nan_debugging``: flips ``jax_debug_nans`` so the divergence check fires
  at the op that produced the NaN instead of at the end of the step.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile: ``with trace('/tmp/tb'): run_step()``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RetraceError(RuntimeError):
    pass


@contextlib.contextmanager
def retrace_guard(jitted_fn: Callable, allowed: int = 0):
    """Fail if ``jitted_fn`` traces more than ``allowed`` additional times
    inside the context.

    Usage::

        step = jax.jit(alg.step)
        state, _ = step(state)              # warmup trace
        with retrace_guard(step):
            for _ in range(100):
                state, _ = step(state)      # must reuse the compiled program
    """
    before = jitted_fn._cache_size()
    yield
    after = jitted_fn._cache_size()
    if after - before > allowed:
        raise RetraceError(
            f"jitted function retraced {after - before} times (allowed "
            f"{allowed}). A pytree structure, static field, or shape is "
            "changing between steps."
        )


@contextlib.contextmanager
def nan_debugging():
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)
