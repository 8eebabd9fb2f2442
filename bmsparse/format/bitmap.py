"""64-bit occupancy-bitmap algebra on pairs of uint32 words.

The reference stores one ``uint64`` bitmap per 8x8 block where bit
``63 - a`` encodes intra-block address ``a`` (``a = rel_i*8 + rel_j``
row-major, or ``rel_j*8 + rel_i`` when the matrix is loaded "transposed";
ref: src/bmSpMatrix.cu:85-101). JAX disables 64-bit integers by
default, so we carry every bitmap as two ``uint32`` words::

    hi = bits 63..32 of the u64  -> intra-block addresses  0..31 (rows 0-3)
    lo = bits 31..0  of the u64  -> intra-block addresses 32..63 (rows 4-7)

i.e. ``bit(a) = (hi >> (31 - a)) & 1`` for ``a < 32`` and
``(lo >> (63 - a)) & 1`` otherwise. All functions below are shape-
polymorphic over a leading batch of blocks and jit/vmap/Pallas friendly.

The reference's key decompression trick — storage position of address ``a``
is ``popcount(bmp >> (64 - a))`` (prefix popcount; ref:
src/bmSparse_SPGEMM.cu:152-162, src/bmSparse_SPMV.cu:72-82) — becomes an
exclusive cumulative sum over the 64 extracted bits (`prefix_popcount`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BLOCK_SIZE

# Shifts to extract address a from (hi, lo): addresses 0..31 live in hi at
# bit (31-a); addresses 32..63 live in lo at bit (63-a).
_HI_SHIFTS = np.arange(31, -1, -1, dtype=np.uint32)  # a = 0..31
_LO_SHIFTS = np.arange(31, -1, -1, dtype=np.uint32)  # a = 32..63


def expand_bits(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """(…,) u32 pair -> (…, 64) int32 in {0,1}, indexed by intra-block address."""
    hi = hi[..., None].astype(jnp.uint32)
    lo = lo[..., None].astype(jnp.uint32)
    hi_bits = (hi >> _HI_SHIFTS) & jnp.uint32(1)
    lo_bits = (lo >> _LO_SHIFTS) & jnp.uint32(1)
    return jnp.concatenate([hi_bits, lo_bits], axis=-1).astype(jnp.int32)


def pack_bits(bits: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(…, 64) {0,1} -> (hi, lo) uint32 pair. Inverse of `expand_bits`."""
    b = bits.astype(jnp.uint32)
    hi = jnp.sum(b[..., :32] << _HI_SHIFTS, axis=-1, dtype=jnp.uint32)
    lo = jnp.sum(b[..., 32:] << _LO_SHIFTS, axis=-1, dtype=jnp.uint32)
    return hi, lo


def popcount(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """Number of set bits per block (per-block nnz), int32."""
    return (
        jax.lax.population_count(hi.astype(jnp.uint32)).astype(jnp.int32)
        + jax.lax.population_count(lo.astype(jnp.uint32)).astype(jnp.int32)
    )


def prefix_popcount(bits: jax.Array) -> jax.Array:
    """Exclusive prefix sum over the address axis: storage slot of each bit.

    ``prefix[..., a]`` = number of set bits at addresses < a. For a set bit
    this is its index inside the block's packed value run — the vectorized
    restatement of ``__popcll(bmp >> (64 - a))``.
    """
    return jnp.cumsum(bits, axis=-1) - bits


def addr_grid(transposed: bool) -> np.ndarray:
    """(8, 8) int32: intra-block address of element (rel_i, rel_j).

    ``transposed`` selects the column-major layout the reference uses for
    the B operand of SpGEMM (ref: src/bmSpMatrix.cu:91-95).
    """
    ri, rj = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    return (rj * 8 + ri if transposed else ri * 8 + rj).astype(np.int32)


def coords_to_words(
    rel_i: jax.Array, rel_j: jax.Array, transposed: bool
) -> tuple[jax.Array, jax.Array]:
    """Per-element single-bit bitmap words for (rel_i, rel_j) coordinates.

    Vectorized `coord_to_bmp` (ref: src/bmSpMatrix.cu:85-101): returns the
    (hi, lo) pair with exactly the one bit for each element set; OR-reducing
    these per block yields the block bitmap.
    """
    a = (rel_j * 8 + rel_i) if transposed else (rel_i * 8 + rel_j)
    in_hi = a < 32
    hi_shift = jnp.clip(31 - a, 0, 31).astype(jnp.uint32)
    lo_shift = jnp.clip(63 - a, 0, 31).astype(jnp.uint32)
    hi = jnp.where(in_hi, jnp.uint32(1) << hi_shift, jnp.uint32(0))
    lo = jnp.where(in_hi, jnp.uint32(0), jnp.uint32(1) << lo_shift)
    return hi.astype(jnp.uint32), lo.astype(jnp.uint32)


def bits_to_dense_bool(bits: jax.Array, transposed: bool) -> jax.Array:
    """(…, 64) bits -> (…, 8, 8) {0,1} int32 dense occupancy, [row, col].

    Undoes the intra-block layout: the result is always logically indexed
    ``[rel_i, rel_j]`` regardless of how the bits were stored.
    """
    g = bits.reshape(bits.shape[:-1] + (8, 8))
    if transposed:
        g = jnp.swapaxes(g, -1, -2)
    return g


def bitmap_product(
    a_hi: jax.Array, a_lo: jax.Array, b_hi: jax.Array, b_lo: jax.Array,
    b_transposed: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Structural product of block bitmaps: C(i,k) = OR_j A(i,j) AND B(j,k).

    Vectorized restatement of `bmp_calculator`
    (ref: src/bmSparse_SPGEMM.cu:787-810). A is row-major; B is column-major
    when ``b_transposed`` (the reference always stores the B operand
    transposed). Output C bitmap is row-major (untransposed).

    Fast path (b_transposed): in the packed words, A's row i and B's
    column k are whole BYTES, so C(i,k) = ((rowbyte_i & colbyte_k) != 0) —
    one fused elementwise chain over (n,) u32 words, ~7x less memory
    traffic than expanding to (n, 64) bit planes.
    """
    if b_transposed:
        a_hi = a_hi.astype(jnp.uint32)
        a_lo = a_lo.astype(jnp.uint32)
        b_hi = b_hi.astype(jnp.uint32)
        b_lo = b_lo.astype(jnp.uint32)
        ff = jnp.uint32(0xFF)
        rows = [
            (a_hi >> jnp.uint32(8 * (3 - i))) & ff for i in range(4)
        ] + [
            (a_lo >> jnp.uint32(8 * (7 - i))) & ff for i in range(4, 8)
        ]
        cols = [
            (b_hi >> jnp.uint32(8 * (3 - k))) & ff for k in range(4)
        ] + [
            (b_lo >> jnp.uint32(8 * (7 - k))) & ff for k in range(4, 8)
        ]
        c_hi = jnp.zeros_like(a_hi)
        c_lo = jnp.zeros_like(a_lo)
        for i in range(8):
            for k in range(8):
                bit = ((rows[i] & cols[k]) != 0).astype(jnp.uint32)
                pos = i * 8 + k
                if pos < 32:
                    c_hi = c_hi | (bit << jnp.uint32(31 - pos))
                else:
                    c_lo = c_lo | (bit << jnp.uint32(63 - pos))
        return c_hi, c_lo

    from .blockops import block_product_bits_flat

    a_bits = expand_bits(a_hi, a_lo)
    b_bits = expand_bits(b_hi, b_lo)
    c_bits = block_product_bits_flat(a_bits, b_bits, b_transposed)
    return pack_bits(c_bits)


def bitmap_or(
    a_hi: jax.Array, a_lo: jax.Array, b_hi: jax.Array, b_lo: jax.Array
) -> tuple[jax.Array, jax.Array]:
    return a_hi | b_hi, a_lo | b_lo


def words_to_u64_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host-side: (hi, lo) uint32 -> uint64 (for interop/debug/binary IO)."""
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def u64_to_words_np(bmp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (bmp >> np.uint64(32)).astype(np.uint32), (
        bmp & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)


assert BLOCK_SIZE == 64, "bitmap algebra is specialized to 8x8 blocks"
