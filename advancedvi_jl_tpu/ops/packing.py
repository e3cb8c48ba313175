"""Tile-packed lower-triangular parameter layout (slice/concat only).

Why this exists: much of the memory traffic of the large-d full-rank VI
step is elementwise passes (Adam, ClipScale, Polyak
averaging, tril masks) over the dense (d, d) scale whose strict upper
triangle is inert by contract.  Packing the scale to the lower-triangular
HALF of that buffer halves every one of those passes; the dense matrix is
materialized only at the two points that genuinely need it (the sampling
matmul and the triangular solve).

Granularity matters: an element-level pack (row-major d(d+1)/2 vector)
needs d^2-sized gathers, which move far more bytes than the slices they
replace.  This module therefore packs at 128x128 TILE granularity: the
packed representation is the (T, 128, 128) array of the T = nb(nb+1)/2
tiles of the (padded) matrix that intersect the lower triangle, in
row-major tile order (tile (i, j), j <= i, lives at index i(i+1)/2 + j).
Pack and unpack are pure static slices and concatenates — layout copies
XLA executes at full bandwidth, with slice/pad adjoints (no gathers, no
scatters, no custom VJPs).  Storage is d^2/2 + O(d·128): diagonal tiles
keep their (inert, zero) upper-of-tile entries so every tile stays a
whole matmul tile.

The reference has no analogue (its scale is a LowerTriangular view over
dense memory, src/families/location_scale.jl:71-77, and its CPU step is
never bandwidth-bound).  Whether it pays on the GPU is open (PERF.md).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

BLOCK = 128  # tile edge


def default_block(d: int) -> int:
    """Tile edge for a given d: the smallest multiple of 128 keeping the
    tile count <= 36 (nb <= 8).  Each slice/concat in pack/unpack is a
    separate HLO op with ~us fixed cost; at block=128 the count grows
    quadratically in d and measured 45% SLOWER than dense at d=2048
    (136 tiles).  Capping nb at 8 keeps the op overhead flat while the
    bandwidth saving still approaches the asymptotic 50% - 1/(2nb)."""
    return 128 * max(1, -(-d // (8 * 128)))


def _nb(d: int, block: int = BLOCK) -> int:
    return -(-d // block)  # ceil


def n_tiles(d: int, block: int | None = None) -> int:
    block = default_block(d) if block is None else block
    nb = _nb(d, block)
    return nb * (nb + 1) // 2


def packed_shape(d: int, block: int | None = None) -> tuple[int, int, int]:
    """Shape of the packed representation: (T, block, block)."""
    block = default_block(d) if block is None else block
    return (n_tiles(d, block), block, block)


def _tile_index(i: int, j: int) -> int:
    return i * (i + 1) // 2 + j


@lru_cache(maxsize=None)
def _tril_tile_mask(block: int) -> np.ndarray:
    return np.tril(np.ones((block, block), dtype=np.float32))


def tril_pack(dense: jax.Array, block: int | None = None) -> jax.Array:
    """(d, d) dense -> (T, block, block) lower-triangle tiles.

    Only the lower triangle of ``dense`` is read (diagonal tiles are
    tril-masked), so inert upper-triangle storage never leaks in.
    """
    d = dense.shape[-1]
    block = default_block(d) if block is None else block
    nb = _nb(d, block)
    D = nb * block
    if D != d:
        dense = jnp.pad(dense, ((0, D - d), (0, D - d)))
    mask = jnp.asarray(_tril_tile_mask(block), dense.dtype)
    tiles = []
    for i in range(nb):
        for j in range(i + 1):
            t = jax.lax.slice(
                dense,
                (i * block, j * block),
                ((i + 1) * block, (j + 1) * block),
            )
            tiles.append(t * mask if i == j else t)
    return jnp.stack(tiles)


def tril_unpack(v: jax.Array, d: int, block: int | None = None) -> jax.Array:
    """(T, block, block) tiles -> (d, d) dense lower-triangular matrix."""
    block = default_block(d) if block is None else block
    nb = _nb(d, block)
    D = nb * block
    mask = jnp.asarray(_tril_tile_mask(block), v.dtype)
    rows = []
    for i in range(nb):
        parts = []
        for j in range(i + 1):
            t = v[_tile_index(i, j)]
            parts.append(t * mask if i == j else t)
        pad = D - (i + 1) * block
        if pad:
            parts.append(jnp.zeros((block, pad), v.dtype))
        rows.append(jnp.concatenate(parts, axis=1))
    dense = jnp.concatenate(rows, axis=0)
    return dense[:d, :d] if D != d else dense


@lru_cache(maxsize=None)
def _diag_tile_indices(d: int, block: int) -> np.ndarray:
    i = np.arange(_nb(d, block))
    return (i * (i + 1) // 2 + i).astype(np.int32)


def packed_diag(v: jax.Array, d: int, block: int | None = None) -> jax.Array:
    """Diagonal of the packed triangle, (d,)."""
    block = default_block(d) if block is None else block
    tii = _diag_tile_indices(d, block)
    diags = [jnp.diagonal(v[int(t)]) for t in tii]
    return jnp.concatenate(diags)[:d]


def packed_with_diag(
    v: jax.Array, d: int, new_diag: jax.Array, block: int | None = None
) -> jax.Array:
    """Packed triangle with its diagonal replaced exactly by ``new_diag``."""
    block = default_block(d) if block is None else block
    nb = _nb(d, block)
    D = nb * block
    if D != d:
        new_diag = jnp.pad(new_diag, (0, D - d))
    tii = jnp.asarray(_diag_tile_indices(d, block))  # (nb,)
    ar = jnp.arange(block)
    vals = new_diag.reshape(nb, block).astype(v.dtype)
    return v.at[tii[:, None], ar[None, :], ar[None, :]].set(vals)
