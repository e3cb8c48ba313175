"""Symmetric matrix square roots for measure-space VI updates.

XLA has no direct ``sqrtm`` op; the reference leans on LAPACK's
``sqrt(Hermitian(...))`` (reference: src/algorithms/klminwassfwdbwd.jl:110,
fisherminbatchmatch.jl:153).  Implementations:

- ``sqrtm_psd``: eigh-based — one batched symmetric eigendecomposition,
  eigenvalues clamped at zero.  Robust default for the small-d (d <= few
  thousand) matrices these algorithms manipulate.
- ``sqrtm_newton_schulz``: matmul-only Newton–Schulz iteration (GEMMs only,
  no eigh) for very large d or half-precision pipelines.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sqrtm_psd(A: jax.Array) -> jax.Array:
    """Principal square root of a symmetric PSD matrix via eigh."""
    A = (A + A.T) / 2.0
    w, V = jnp.linalg.eigh(A)
    w = jnp.maximum(w, 0.0)
    return (V * jnp.sqrt(w)) @ V.T


def inv_sqrtm_psd(A: jax.Array, eps: float = 1e-12):
    """(A^{1/2}, A^{-1/2}) for symmetric positive definite A."""
    A = (A + A.T) / 2.0
    w, V = jnp.linalg.eigh(A)
    w = jnp.maximum(w, eps)
    sw = jnp.sqrt(w)
    return (V * sw) @ V.T, (V / sw) @ V.T


def sqrtm_newton_schulz(A: jax.Array, n_iter: int = 20) -> jax.Array:
    """Newton–Schulz iteration for the PSD square root (matmuls only).

    Converges quadratically when ||I - A/||A||_F|| < 1; we pre-scale by the
    Frobenius norm.  All ops are (d, d) matmuls.
    """
    dtype = A.dtype
    d = A.shape[-1]
    norm = jnp.sqrt(jnp.sum(jnp.square(A)))
    Y0 = A / norm
    Z0 = jnp.eye(d, dtype=dtype)
    I = jnp.eye(d, dtype=dtype)

    def body(_, YZ):
        Y, Z = YZ
        T = 0.5 * (3.0 * I - Z @ Y)
        return (Y @ T, T @ Z)

    Y, _ = jax.lax.fori_loop(0, n_iter, body, (Y0, Z0))
    return Y * jnp.sqrt(norm)
