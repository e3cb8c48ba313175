"""Native C++ XLA-FFI custom calls (CPU backend).

The C++ home for the batched triangular solve (SURVEY.md §2.8.2/§2.8.4;
reference hot path: src/families/location_scale.jl:59-63
``scale \\ (z - location)``).  The kernel lives in ops/cpp/ffi_trisolve.cc,
compiled on first use (ops/native_build.py) against the XLA FFI headers
bundled with jaxlib and registered with ``jax.ffi.register_ffi_target`` for
the **CPU** platform only: on a GPU backend the solves stay on XLA's
``triangular_solve`` (cuBLAS trsm), and this module never engages.

``trisolve`` is differentiable (custom VJP re-uses the same kernel with the
transposed system) and jit/vmap-safe on the CPU backend.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

_REGISTERED = False
_FAILED = False


def _src_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "cpp")


def _ensure_registered() -> bool:
    """Compile (if stale) + register the FFI targets; False if unavailable."""
    global _REGISTERED, _FAILED
    if _REGISTERED:
        return True
    if _FAILED:
        return False
    from .native_build import build_shared_library

    src = os.path.join(_src_dir(), "ffi_trisolve.cc")
    try:
        out = build_shared_library(
            src,
            [
                "-O3", "-funroll-loops", "-std=c++17", "-shared", "-fPIC",
                "-I", jax.ffi.include_dir(),
            ],
        )
        lib = ctypes.cdll.LoadLibrary(out)
        for name, sym in (
            ("advi_trisolve_f32", lib.AdviTrisolveF32),
            ("advi_trisolve_f64", lib.AdviTrisolveF64),
        ):
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(sym), platform="cpu"
            )
        _REGISTERED = True
    except subprocess.CalledProcessError as e:
        import warnings

        stderr = (e.stderr or b"").decode(errors="replace")
        warnings.warn(
            f"native FFI kernel compilation failed (g++ exit {e.returncode});"
            f" falling back to XLA solves. Compiler stderr:\n{stderr}"
        )
        _FAILED = True
    except Exception:
        _FAILED = True
    return _REGISTERED


def ffi_available() -> bool:
    """True when the native kernel compiled+registered AND the default
    backend is CPU (the platform the targets are registered for)."""
    return jax.default_backend() == "cpu" and _ensure_registered()


def use_native_trisolve(L: jax.Array, B: jax.Array) -> bool:
    """Should a library solve path route through the native kernel?

    True only when every condition a caller shouldn't have to re-derive
    holds: CPU backend with a registered kernel, f32/f64 operands, 2-D
    un-batched system, and NO active mesh — under GSPMD a custom call is an
    opaque (non-partitionable) op, so sharded solves stay on XLA's
    ``triangular_solve`` which partitions over the sample axis.
    """
    if L.dtype not in (jnp.float32, jnp.float64) or L.dtype != B.dtype:
        return False
    if L.ndim != 2 or B.ndim != 2:
        return False
    mesh = jax.sharding.get_abstract_mesh()
    if mesh is not None and not mesh.empty:
        return False
    return ffi_available()


def _target_name(dtype) -> str:
    if dtype == jnp.float32:
        return "advi_trisolve_f32"
    if dtype == jnp.float64:
        return "advi_trisolve_f64"
    raise TypeError(f"native trisolve supports f32/f64, got {dtype}")


def _raw_trisolve(L: jax.Array, B: jax.Array, trans: int) -> jax.Array:
    call = jax.ffi.ffi_call(
        _target_name(L.dtype),
        jax.ShapeDtypeStruct(B.shape, B.dtype),
        vmap_method="sequential",
    )
    return call(L, B, trans=np.int32(trans))


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _trisolve(L: jax.Array, B: jax.Array, trans: int) -> jax.Array:
    return _raw_trisolve(L, B, trans)


def _trisolve_fwd(L, B, trans):
    X = _raw_trisolve(L, B, trans)
    return X, (L, X)


def _trisolve_bwd(trans, res, G):
    # X = op(L)^{-1} B with op(L) = L or L^T.  For both cases:
    #   bar_B = op(L)^{-T} G  (the transposed system, same kernel)
    #   bar_L = -tril(bar_B @ X^T)   [trans=0]  /  -tril(X @ bar_B^T) [trans=1]
    L, X = res
    bar_B = _raw_trisolve(L, G, 1 - trans)
    outer = bar_B @ X.T if trans == 0 else X @ bar_B.T
    bar_L = -jnp.tril(outer)
    return bar_L, bar_B


_trisolve.defvjp(_trisolve_fwd, _trisolve_bwd)


def trisolve(L: jax.Array, B: jax.Array, *, trans: bool = False) -> jax.Array:
    """Solve ``L X = B`` (or ``L^T X = B``) with the native C++ FFI kernel.

    Args:
      L: (d, d) lower-triangular matrix (upper triangle ignored).
      B: (d, n) right-hand sides — one SAMPLE PER COLUMN so the native
         substitution streams unit-stride length-n vectors (transpose
         (n, d) sample batches before calling).
      trans: solve with ``L^T`` instead (back substitution).

    Differentiable in L and B; jit-safe and vmap-able (sequential per-batch
    dispatch); CPU backend only (``ffi_available()``) — the targets are
    registered for platform="cpu", so a GPU default backend gets a clear
    error here instead of an opaque lowering failure.
    """
    if L.ndim != 2 or B.ndim != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"expected L (d,d), B (d,n); got {L.shape}, {B.shape}")
    if L.shape[1] != B.shape[0]:
        raise ValueError(f"shape mismatch: L {L.shape} vs B {B.shape}")
    if not ffi_available():
        raise RuntimeError(
            "native FFI trisolve unavailable: it requires the CPU backend "
            f"(current: {jax.default_backend()!r}) and a successful kernel "
            "compilation. Use jax.scipy.linalg.solve_triangular instead."
        )
    B = B.astype(L.dtype)
    return _trisolve(L, B, 1 if trans else 0)
