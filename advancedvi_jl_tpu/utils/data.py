"""Host data loader backed by the native C++ reshuffle engine.

For datasets larger than device memory, the device-side schedule (subsampling.py) can't
hold the data; this loader keeps the dataset in host RAM (or mmap), draws the
epoch permutation and gathers minibatch rows in native threads off the GIL
(ops/cpp/reshuffle.cc), and hands contiguous float32 staging arrays to the
caller to `jax.device_put` (optionally double-buffered by the training loop).

The library is compiled on first use (ops/native_build.py); if
compilation is impossible the loader falls back to a numpy implementation
with identical semantics — same permutations are NOT guaranteed between the
two backends (splitmix64 vs numpy), but both are deterministic per seed.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _src_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "ops", "cpp")


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    from ..ops.native_build import build_shared_library

    src = os.path.join(_src_dir(), "reshuffle.cc")
    try:
        out = build_shared_library(src, ["-O3", "-shared", "-fPIC"])
        lib = ctypes.CDLL(out)
        lib.avt_fill_permutation.argtypes = [
            ctypes.c_uint64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.avt_gather_rows_f32.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.avt_epoch_batches.argtypes = [
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


def native_available() -> bool:
    return _load_lib() is not None


def fill_permutation(seed: int, n: int) -> np.ndarray:
    lib = _load_lib()
    out = np.empty(n, np.int32)
    if lib is not None:
        lib.avt_fill_permutation(seed, n, out)
        return out
    rng = np.random.default_rng(seed)
    return rng.permutation(n).astype(np.int32)


def gather_rows(
    src: np.ndarray, idx: np.ndarray, n_threads: int = 0
) -> np.ndarray:
    """dst[k, :] = src[idx[k], :] with native threaded memcpy."""
    lib = _load_lib()
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    dst = np.empty((idx.shape[0], src.shape[1]), np.float32)
    if lib is not None:
        if n_threads <= 0:
            n_threads = min(8, os.cpu_count() or 1)
        lib.avt_gather_rows_f32(
            src, idx, dst, idx.shape[0], src.shape[1], n_threads
        )
        return dst
    return src[idx]


class HostDataLoader:
    """Epoch-reshuffled minibatch iterator over host-resident arrays.

    Same schedule contract as the device-side ReshufflingBatchSubsampling
    (full batches only, reshuffle per epoch), for datasets beyond HBM.
    """

    def __init__(self, X: np.ndarray, y: Optional[np.ndarray], batchsize: int,
                 seed: int = 0):
        self.X = np.ascontiguousarray(X, np.float32)
        self.y = (
            np.ascontiguousarray(y.reshape(len(y), -1), np.float32)
            if y is not None
            else None
        )
        self.batchsize = batchsize
        self.n_data = X.shape[0]
        self.n_batches = self.n_data // batchsize
        if self.n_batches == 0:
            raise ValueError("batchsize exceeds dataset size")
        self.seed = seed
        self.epoch = 0
        self._step = 0
        self._perm = fill_permutation(seed, self.n_data)

    def __len__(self) -> int:
        return self.n_batches

    def next_batch(self) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """(X_batch, y_batch, indices); advances the schedule."""
        lo = self._step * self.batchsize
        idx = self._perm[lo : lo + self.batchsize]
        Xb = gather_rows(self.X, idx)
        yb = gather_rows(self.y, idx) if self.y is not None else None
        self._step += 1
        if self._step >= self.n_batches:
            self.epoch += 1
            self._step = 0
            self._perm = fill_permutation(
                self.seed + 0x9E3779B9 * self.epoch, self.n_data
            )
        return Xb, yb, idx


class PrefetchingLoader:
    """Background-thread prefetch around a HostDataLoader.

    While the device runs step t, a host thread gathers batch t+1 with the
    native engine — the threaded memcpy overlaps device compute instead of
    serializing with it (depth 2 suffices since VI steps consume one batch
    each).  The worker stays pure-host (numpy only): issuing jax ops from a
    second thread while the main thread compiles is not safe, so the
    device transfer happens on the consuming thread.
    """

    def __init__(self, loader: HostDataLoader, depth: int = 2):
        import queue
        import threading

        self.loader = loader
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            import queue as _queue

            while not self._stop.is_set():
                item = self.loader.next_batch()
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except _queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_batch(self):
        return self._queue.get()

    def close(self) -> None:
        self._stop.set()
        # drain so the worker unblocks from a full queue
        try:
            while True:
                self._queue.get_nowait()
        except Exception:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def optimize_streamed(
    key,
    algorithm,
    max_iter: int,
    prob_template,
    place_batch,
    loader,
    q_init,
):
    """Host-streamed doubly-stochastic VI for datasets beyond HBM.

    The device-side schedule (ReshufflingBatchSubsampling) requires the full
    dataset resident on device; this driver instead streams minibatches from
    host RAM through the native gather engine (wrap the loader in
    PrefetchingLoader to overlap the gathers with device compute):

        prob = factorized_target(logprior, loglike,
                                 data={"y": y_staging}, dim=d)
        prob = dataclasses.replace(prob, likeadj=jnp.asarray(N / B))
        q, infos, state = optimize_streamed(
            key, alg, 10_000, prob,
            place_batch=lambda p, Xb, yb: dataclasses.replace(
                p, data={"y": yb}),
            loader=PrefetchingLoader(HostDataLoader(X, y, batchsize=B)),
            q_init=q0)

    ``prob_template`` is built ONCE (batch-shaped data, likeadj = N/B
    already applied); ``place_batch(prob, X_batch, y_batch) -> prob`` must
    only swap array leaves (e.g. ``dataclasses.replace(prob, data=...)``) —
    creating a fresh target with new closures per step would change the jit
    cache key and recompile every iteration.  ``algorithm`` is any
    ParamSpaceSGD whose objective does NOT also wrap SubsampledObjective
    (batching happens here).  Returns ``(output, infos, state)`` like
    ``optimize``.
    """
    import dataclasses

    import jax

    state = algorithm.init(key, q_init, prob_template)

    def step_fn(state, Xb, yb):
        prob = place_batch(state.prob, Xb, yb)
        state = dataclasses.replace(state, prob=prob)
        return algorithm.step(state)

    step = jax.jit(step_fn)
    infos = []
    for t in range(max_iter):
        Xb, yb, _ = loader.next_batch()
        state, info = step(state, Xb, yb)
        infos.append(dict(jax.device_get(info)))
        if infos[-1].get("diverged", False):
            from ..optimize import DivergenceError

            raise DivergenceError(
                f"The objective became non-finite at iteration {t + 1}."
            )
    for i, row in enumerate(infos):
        row["iteration"] = i + 1
    return algorithm.output(state), infos, state
