"""Level-parallel blocked triangular inverse (matmul-only above the base).

Why: a triangular solve (XLA's ``triangular_solve``, cuBLAS trsm on a GPU)
is blocked substitution — O(d/block) dependent steps whose per-step matmuls
are small.  At the VI hot-path shapes (one (d, d) factor, n ~ 10^2
right-hand sides) that dependency chain, not the arithmetic, can set the
solve's wall-clock.

This kernel restructures the computation as the classic divide-and-conquer
inverse:

    [[A, 0], [B, D]]^{-1} = [[A^{-1}, 0], [-D^{-1} B A^{-1}, D^{-1}]]

evaluated bottom-up: ONE batched 128x128 base inversion (all d/128 diagonal
blocks in parallel), then log2(d/128) levels where every pair's off-diagonal
correction -D^{-1} B A^{-1} is two batched (s, s) matmuls — independent
across pairs, O(log d) sequential depth instead of O(d/128).
Total ~2/3 d^3 FLOPs.

An opt-in (``FullRankLocationScale(solve_mode="inverse")``); its full STL
step time against the solve's on the H100 is in PERF.md.  The crossover is
shape-dependent (more rhs amortize the inverse's fixed cost; substitution
wins worst-case rounding on ill-conditioned factors).  Parity (values,
gradients, training trajectories) is pinned in tests/test_trinv.py.
Differentiable by construction (solves + matmuls).

No reference counterpart (the reference delegates to LAPACK trsm,
reference: src/families/location_scale.jl:59-63).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

_BASE = 128  # tile edge: base-case inversion size


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def supports_blocked_inverse(d: int, block: int = _BASE) -> bool:
    """Shape gate: d must tile into a power-of-two number of base blocks."""
    return d % block == 0 and _is_pow2(d // block)


def tril_inverse(C: jax.Array, block: int = _BASE) -> jax.Array:
    """Inverse of a lower-triangular (d, d) matrix, level-parallel.

    Falls back to one dense triangular solve against I when the shape gate
    fails (small or odd d) — correctness never depends on the fast path.
    """
    d = C.shape[0]
    if not supports_blocked_inverse(d, block):
        return solve_triangular(
            C, jnp.eye(d, dtype=C.dtype), lower=True
        )

    nb = d // block
    # Base case: batched inversion of the nb diagonal (block, block) blocks.
    diag_idx = jnp.arange(nb)
    diag_blocks = C.reshape(nb, block, nb, block)[diag_idx, :, diag_idx, :]
    eye = jnp.eye(block, dtype=C.dtype)
    X = jax.vmap(lambda b: solve_triangular(b, eye, lower=True))(diag_blocks)

    # Bottom-up pair merge.  Invariant: X is the (p, m, m) batch of the
    # inverses of C's p = d/m diagonal (m, m) blocks.  Each level merges
    # consecutive pairs [[A, 0], [B, D]] -> [[Ai, 0], [-Di B Ai, Di]].
    # Everything stays batch-contiguous: A/D split by a (p, 2, m, m)
    # reshape, B by ONE diagonal gather from the original C, and the merged
    # inverse is assembled with concatenates — no tile-grid scatters (the
    # previous tile-indexed formulation spent the matmul win on its
    # gather/scatter passes; BENCH_NOTES "Round 3").
    m = block
    p = nb
    while p > 1:
        p //= 2
        X = X.reshape(p, 2, m, m)
        Ai, Di = X[:, 0], X[:, 1]
        # B_i = C[(2i+1)m : (2i+2)m, 2i*m : (2i+1)m]: the sub-diagonal
        # (m, m) blocks of the 2m-partition of C.
        idx = jnp.arange(p)
        B = C.reshape(p, 2 * m, p, 2 * m)[idx, m:, idx, :m]
        O = -jnp.einsum("pij,pjk->pik", Di, jnp.einsum("pij,pjk->pik", B, Ai))
        X = jnp.concatenate(
            [
                jnp.concatenate([Ai, jnp.zeros_like(O)], axis=2),
                jnp.concatenate([O, Di], axis=2),
            ],
            axis=1,
        )
        m *= 2

    return X[0]
