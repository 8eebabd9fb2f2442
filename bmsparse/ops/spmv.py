"""Sparse matrix-vector multiply u = A @ v on BmSparse.

Restatement of the reference SpMV (ref: src/bmSparse_SPMV.cu:72-230) in
XLA. The reference launches one CUDA block per 8-row strip, stages each
8x8 block into shared memory via prefix-popcount decompression, does 64
FMAs and a shuffle tree-reduction (`spmv_kernel` :153-189; the "batched"
`spmv_kernel_new` :84-150 processes 4 blocks per iteration). Two paths:

  * a raw BmSparse runs `_spmv_xla`: decompress blocks -> (nb, 8, 8)
    dense tiles, gather v segments -> (nb, 8), per-block matvec +
    segment-sum over block rows (one jitted program);
  * a Prepared plan (ops/plan.py) runs `_spmv_prepared`: the DIA, SELL
    and stream tiers.

The reference's host-side `first_blocks` row index (exclusive scan of
per-block-row counts, ref: :196-206) is unnecessary here: segment_sum over
`brow` performs the same reduction without materializing the index. Note
the reference sizes its grid with num_cols where num_rows is meant
(ref: :217,220 — correct only for square matrices); we implement the
intended semantics with explicit shapes.

Padding blocks (bmp == 0) contribute exact zeros, so both implementations
are safe on padded containers — this is what makes the op shard_map-able.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import BLOCK_HEIGHT, BLOCK_WIDTH
from ..format.bmsparse import BmSparse, cdiv


# Blocks decompressed per scan step; bounds the (chunk, 64) working set to
# a few MB regardless of matrix size (layout note in format/blockops.py).
_SPMV_CHUNK = 1 << 17


@jax.jit
def _spmv_xla(m: BmSparse, v: jax.Array) -> jax.Array:
    from ..format import bitmap as bm
    from ..format.blockops import block_matvec_flat

    nbr = m.block_rows
    # Pad (or trim) v to whole blocks so per-block gathers are in-bounds;
    # the multi-chip path passes an all-gathered v that may be longer.
    n = m.block_cols * BLOCK_WIDTH
    if v.shape[0] >= n:
        vpad = v[:n]
    else:
        vpad = jnp.zeros((n,), v.dtype).at[: v.shape[0]].set(v)
    acc_dtype = jnp.promote_types(m.dtype, jnp.float32)
    values = m.values
    nnz_pad = m.nnz_pad

    def chunk_contrib(hi, lo, off, bcol, brow, u):
        bits = bm.expand_bits(hi, lo)                       # (c, 64)
        slot = bm.prefix_popcount(bits)
        idx = jnp.clip(off[:, None] + slot, 0, nnz_pad - 1)
        dense = jnp.where(bits > 0, jnp.take(values, idx, axis=0), 0)
        # storage is row-major (SpMV requires untransposed matrices)
        vseg = vpad[
            bcol[:, None] * BLOCK_WIDTH + jnp.arange(BLOCK_WIDTH)[None, :]
        ]
        contrib = block_matvec_flat(dense, vseg, acc_dtype)  # (c, 8)
        # Padding blocks carry the brow sentinel -> dropped by num_segments.
        return u + jax.ops.segment_sum(contrib, brow, num_segments=nbr)

    nb = m.nb_pad
    u0 = jnp.zeros((nbr, BLOCK_HEIGHT), acc_dtype)
    if nb <= _SPMV_CHUNK:
        u = chunk_contrib(m.bmp_hi, m.bmp_lo, m.offsets, m.bcol, m.brow, u0)
    else:
        chunk = _SPMV_CHUNK
        nchunks = -(-nb // chunk)
        pad = nchunks * chunk - nb

        def padded(x, fill):
            return jnp.concatenate(
                [x, jnp.full((pad,), fill, x.dtype)]
            ).reshape(nchunks, chunk)

        hi = padded(m.bmp_hi, 0)
        lo = padded(m.bmp_lo, 0)
        off = padded(m.offsets, 0)
        bcol = padded(m.bcol, 0)
        brow = padded(m.brow, nbr)  # sentinel -> dropped

        def step(u, xs):
            return chunk_contrib(*xs, u), None

        u, _ = jax.lax.scan(step, u0, (hi, lo, off, bcol, brow))
    return u.reshape(nbr * BLOCK_HEIGHT)[: m.num_rows].astype(v.dtype)


@jax.jit
def _spmv_prepared(p, v: jax.Array) -> jax.Array:
    """Tiered SpMV on a Prepared matrix (see ops/plan.py).

    DIA tier: ndiags shifted fused multiply-adds over the rows — no
    gathers, no scatters.
    SELL tier: lane = block-row; per-chunk-K padding turns the per-row
    reduction into a dense axis-sum; the only dynamic accesses are one
    gather of v block segments per K-group and the final
    inverse-permutation row gather.
    """
    m = p.m
    # compute dtype: f32 accumulation for f32/bf16 plans (a bf16 plan
    # halves tier storage/traffic — the reference's half-input regime),
    # f64 for double matrices on the CPU path
    cdt = jnp.promote_types(jnp.dtype(p.plan_dtype), jnp.float32)
    nbr = m.block_rows
    nbc = m.block_cols
    npad = nbr * BLOCK_HEIGHT
    n = nbc * BLOCK_WIDTH
    if v.shape[0] >= n:
        vpad = v[:n].astype(cdt)
    else:
        vpad = (
            jnp.zeros((n,), cdt).at[: v.shape[0]].set(v)
        )

    u = jnp.zeros((npad,), cdt)

    if p.dia is not None:
        u2 = dia_apply(p.dia, p.dia_offsets, vpad, n)
        u = u + u2.reshape(-1)[:npad]

    if p.sell_ks:
        u_sell = sell_apply(
            p.sell_dense, p.sell_bcol, p.out_gather, vpad, nbc,
        )                                              # (nbr, 8)
        u = u + u_sell.reshape(npad)

    if p.stream is not None:
        from .route import stream_apply

        u_s = stream_apply(p.stream, vpad)
        u = u.at[: u_s.shape[0]].add(u_s.astype(cdt))

    return u[: m.num_rows].astype(v.dtype)


def dia_apply(
    dia: jax.Array,
    offsets: tuple,
    vpad: jax.Array,
    n: int,
    col_shift=None,
    max_shift_rows: int = 0,
):
    """DIA-tier contribution: u2 (r_rows, 128), row e at [e // 128, e % 128].

    u[e] = sum_d dia[d, e] * v[e + col_shift + offsets[d]]: one shifted
    slice of a zero-padded flat v per diagonal, all summed in one fused
    elementwise pass (no shifted copies of v are materialised).

    col_shift: optional TRACED scalar: diagonal offset d reads
    v[row + col_shift + offsets[d]]. Used by the multi-chip path, where
    each shard's rows are local but v (and the diagonal offsets, which are
    global statics shared by every shard) live in global coordinates.

    max_shift_rows: static upper bound on col_shift // 128. The padded
    vector must cover the sliding window of EVERY shard; for tall matrices
    (num_rows >> num_cols) a late shard's base exceeds n and
    dynamic_slice would silently clamp, misreading that shard's
    diagonals — so the slice source is sized by this bound, not by n.
    """
    cdt = jnp.promote_types(dia.dtype, jnp.float32)
    r_rows = dia.shape[1]
    npad = r_rows * 128
    lead = max(abs(o) for o in offsets)
    span = (max(n, max_shift_rows * 128) + npad if col_shift is not None
            else max(n, npad))
    vx = jnp.pad(vpad[:n].astype(cdt), (lead, span - n + lead))
    if col_shift is not None:
        # slide the local window: vx[i] is global v[i - lead + col_shift]
        vx = jax.lax.dynamic_slice(vx, (col_shift,), (lead + npad + lead,))
    u = jnp.zeros((npad,), cdt)
    for d, o in enumerate(offsets):
        u = u + dia[d].reshape(npad) * vx[lead + o: lead + o + npad]
    return u.reshape(r_rows, 128)


def sell_apply(
    sell_dense: tuple,
    sell_bcol: tuple,
    out_gather: jax.Array,
    vpad: jax.Array,
    nbc: int,
    col_base=None,
    global_sentinel: int | None = None,
):
    """SELL-tier contribution: (block_rows, 8) row-major.

    Per K-group: ONE v-segment gather per slot, a fused multiply-reduce
    over (window scalar, k), a lane->sublane transpose; then the
    inverse-permutation row gather places rows (fill rows -> 0).

    The slot granularity is encoded in the plan arrays (dense_g's leading
    axis): cw = 8 means one slot per 8x8 block (v table (8, nbc+1)),
    cw = 64 means super-slots merging a row's blocks that share one
    64-scalar column window (v table (64, nbc/8+1)) — 1/merge-factor as
    many gather indices for column-clustered structures.

    col_base/global_sentinel: multi-chip halo mode — bcol indices are
    GLOBAL block columns while vpad is a shard-local window starting at
    block column col_base (traced); sentinel (= the global block-column
    count) remaps to the window's zero column. Halo plans always use
    cw = 8 (window starts need not be 64-aligned across shards).
    """
    cdt = jnp.promote_types(sell_dense[0].dtype, jnp.float32)
    cw = sell_dense[0].shape[0]
    ncu = cdiv(nbc * BLOCK_WIDTH, cw)   # column units of cw scalars
    # v as (cw, ncu + 1): column ncu is zero — the gather's padding
    # sentinel
    vflat = vpad[: nbc * BLOCK_WIDTH]
    if ncu * cw != vflat.shape[0]:
        vflat = jnp.concatenate(
            [vflat, jnp.zeros((ncu * cw - vflat.shape[0],), cdt)])
    vtab = jnp.concatenate(
        [vflat.reshape(ncu, cw).T, jnp.zeros((cw, 1), cdt)], axis=1)
    parts = []
    for g, (dense_g, bcol_g) in enumerate(zip(sell_dense, sell_bcol)):
        cw_g, ch, kg, _, lanes = dense_g.shape
        # one gather per group: a single fused take over all groups
        # would materialise the full (cw, slots) gather result
        if col_base is not None:
            bcol_g = jnp.clip(
                jnp.where(
                    bcol_g == global_sentinel, jnp.int32(ncu),
                    bcol_g - col_base,
                ),
                0, ncu,
            )
        vseg = jnp.take(
            vtab, bcol_g.reshape(ch, kg, lanes), axis=1
        ).reshape(cw_g, ch, kg, 1, lanes)
        # single fused multiply-reduce over (window, k) — an unrolled
        # loop would re-read the accumulator
        contrib = jnp.sum(dense_g * vseg, axis=(0, 2))       # (ch, 8, 128)
        parts.append(
            jnp.transpose(contrib, (0, 2, 1)).reshape(-1, BLOCK_HEIGHT)
        )
    u_rows = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    # rows with no SELL blocks point at the appended zero row (an
    # in-bounds gather; mode="fill" forces a slower masked-gather path)
    u_ext = jnp.concatenate(
        [u_rows, jnp.zeros((1, BLOCK_HEIGHT), u_rows.dtype)]
    )
    return jnp.take(u_ext, jnp.minimum(out_gather, u_rows.shape[0]), axis=0)


def spmv(m, v: jax.Array) -> jax.Array:
    """u = A @ v.

    Args:
      m: BmSparse matrix (untransposed intra-block layout), or a Prepared
        plan from ops.plan.prepare() — recommended when the matrix is
        reused (the raw-container path decompresses every call).
      v: dense vector of length m.num_cols.

    A Prepared operand runs the tiered plan; a raw BmSparse runs the
    jit-safe _spmv_xla. spmv never calls prepare() itself: that is a
    host-side numpy plan build, which cannot run under a jit trace.
    """
    from .plan import Prepared

    if m.transposed:
        raise ValueError("SpMV expects an untransposed (row-major) matrix")
    if v.shape[0] != m.num_cols:
        raise ValueError(f"v has length {v.shape[0]}, expected {m.num_cols}")
    if isinstance(m, Prepared):
        return _spmv_prepared(m, v)
    return _spmv_xla(m, v)


# ---------------------------------------------------------------------------
# CSR reference SpMV — BASELINE config 1 ("CSR SpMV ... CPU reference path").
# ---------------------------------------------------------------------------
@jax.jit
def csr_spmv(a, v: jax.Array) -> jax.Array:
    """u = A @ v for a CSRMatrix, as a gather + segment-sum."""
    contrib = a.data * jnp.take(v, a.indices, axis=0)
    return jax.ops.segment_sum(contrib, a.row_ids(), num_segments=a.num_rows)
