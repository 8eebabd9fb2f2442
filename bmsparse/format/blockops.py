"""Flat 8x8-block arithmetic in (n, 64) layout.

All hot-path block math stays in (n, 64) "flat slot" layout (slot =
rel_i*8 + rel_j, row-major): one contiguous 64-value row per block, the
layout the SpGEMM task tables and the compress stage share.

An 8x8 block product C = A @ B in flat layout is eight fused
multiply-accumulates over 64 lanes:

    C[t, i*8+k] = sum_j A[t, i*8+j] * B[t, j*8+k]
                = sum_j repeat8(A[:, j::8]) * tile8(B[:, j*8:j*8+8])

because repeat8 places A(:, i, j) at slot i*8+k for all k and tile8 places
B(:, j, k) at slot i*8+k for all i. This is the analogue of the
reference's scalar FMA variant multiplyV15 (ref:
src/bmSparse_SPGEMM.cu:205-291) — which is also the reference's default
(tc_version=5, ref :1230).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Permutation taking transposed-storage slots (rel_j*8+rel_i) to row-major
# slots (rel_i*8+rel_j); it is an involution.
TRANSPOSE_PERM = (
    (np.arange(64) % 8) * 8 + (np.arange(64) // 8)
).astype(np.int32)


def repeat8(x8: jax.Array) -> jax.Array:
    """(n, 8) -> (n, 64) with x[:, i] at every slot i*8+k."""
    return jnp.repeat(x8, 8, axis=-1)


def tile8(x8: jax.Array) -> jax.Array:
    """(n, 8) -> (n, 64) with x[:, k] at every slot i*8+k."""
    return jnp.tile(x8, (1,) * (x8.ndim - 1) + (8,))


def block_matmul_flat(
    a_flat: jax.Array,
    b_flat: jax.Array,
    b_transposed: bool,
    acc_dtype=jnp.float32,
) -> jax.Array:
    """Per-task 8x8 block product in flat layout.

    a_flat: (n, 64) row-major slots of the A blocks.
    b_flat: (n, 64) slots of the B blocks in their STORAGE layout
      (column-major when b_transposed — the layout the reference keeps B in
      precisely to make column access contiguous, ref: src/bmSpMatrix.cu:91-95).
    Returns (n, 64) row-major C = A @ B, accumulated in acc_dtype.
    """
    acc = jnp.zeros(a_flat.shape, acc_dtype)
    for j in range(8):
        a_j = a_flat[..., j::8]                      # A(:, i, j) -> (n, 8)
        if b_transposed:
            b_j = b_flat[..., j::8]                  # stored k*8+j -> B(:, j, k)
        else:
            b_j = b_flat[..., j * 8 : j * 8 + 8]     # stored j*8+k
        acc = acc + repeat8(a_j.astype(acc_dtype)) * tile8(b_j.astype(acc_dtype))
    return acc


def block_matvec_flat(
    a_flat: jax.Array, v8: jax.Array, acc_dtype=jnp.float32
) -> jax.Array:
    """(n, 64) row-major blocks x (n, 8) vector segments -> (n, 8) row sums.

    u[t, i] = sum_j A[t, i*8+j] * v[t, j].
    """
    prod = a_flat.astype(acc_dtype) * tile8(v8.astype(acc_dtype))
    return jnp.sum(prod.reshape(prod.shape[:-1] + (8, 8)), axis=-1)


def block_product_bits_flat(
    a_bits: jax.Array, b_bits: jax.Array, b_transposed: bool
) -> jax.Array:
    """Structural product of occupancy bits: C(i,k) = OR_j A(i,j) & B(j,k).

    Flat-layout restatement of the reference's bmp_calculator
    (ref: src/bmSparse_SPGEMM.cu:787-810). Inputs/outputs are (n, 64)
    int32 in {0,1}; b_bits in storage layout.
    """
    acc = jnp.zeros(a_bits.shape, jnp.int32)
    for j in range(8):
        a_j = a_bits[..., j::8]
        b_j = b_bits[..., j::8] if b_transposed else b_bits[..., j * 8 : j * 8 + 8]
        acc = acc + repeat8(a_j) * tile8(b_j)
    return (acc > 0).astype(jnp.int32)


def storage_to_rowmajor(flat: jax.Array, transposed: bool) -> jax.Array:
    """Reorder (n, 64) slots from storage layout to row-major."""
    if not transposed:
        return flat
    return jnp.take(flat, jnp.asarray(TRANSPOSE_PERM), axis=-1)
