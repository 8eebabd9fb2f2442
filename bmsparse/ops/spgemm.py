"""Sparse matrix - sparse matrix multiply C = A @ B on BmSparse.

Restatement of the reference SpGEMM in XLA
(`bmSparse_mult`, ref: src/bmSparse_SPGEMM.cu:827-1223). The reference's
phases map as follows (phase labels T1..T6 follow SURVEY.md §2 #4):

  T1  B blocks per block-row (reduce_by_key/is_same_row, ref :840-847)
        -> segment_sum over B.brow
  T2  per-A-block task counts (gather, ref :857-864)
        -> take(B_row_count, A.bcol)
  T3  task-list expansion (scan/scatter/task_creator, ref :875-932)
        -> ONE jnp.repeat over stacked per-block fields
  T4  bitmap-product pruning (remove_if/multiplication_checker, ref :944-948)
        -> bit-parallel byte-AND structural product on the packed words
           (format/bitmap.py); zero-product tasks sort to the tail
  T5  sort tasks by C key (thrust::sort | bb_segsort, ref :963-1016)
        -> one lax.sort with lexicographic (row, col) int32 keys carrying
           the task product bitmaps; replaces both strategies and the
           BORDER=2,730,000 crossover (ref :53)
  T6  C structure: keys, bitmaps (bmp_calculator OR-reduction), offsets,
      nnz (ref :1031-1107)
        -> segment ids + row-granular segment_sum of bit planes + cumsum

  numeric multiplyV11..V15 (ref :205-733) -> task-SELL layout: C block on
      a 128-wide axis, sigma-sorted by task count, per-chunk-K padded;
      A/B tiles gathered from transposed (64, nb+1) tables; the 8x8
      block product is 8 fused multiply-accumulates (the analogue of
      the reference's default scalar variant tc_version=5, ref :1230);
      accumulation is a dense K-sum; bit-order packing is the row-granular
      sort-compaction in _compress_rows. The chunked segment-sum path
      (_numeric_xla) remains for the jit-safe padded/shard_map entry.

Two entry points:
  * `spgemm(A, B)`       — host-orchestrated: syncs the data-dependent
    sizes (task count, C block count, C nnz) to host between jitted
    stages, exactly where the reference does its D->H memcpys
    (ref :1095,1106), with shape-bucketing to bound recompiles.
  * `spgemm_padded(A, B, max_tasks, max_c_blocks, max_c_nnz)` — fully
    jit-compatible with caller-supplied upper bounds (used by shard_map
    multi-chip path and compile checks).

Numerics: inputs any float dtype (the reference uses fp16),
accumulation/output fp32 (ref OUTPUT_TYPE, src/bmSparse_SPGEMM.cu:51).
C's structure is the *structural* product — numerically-cancelled entries
are stored as explicit zeros, exactly like the reference.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import bucket_size, get_config
from ..format import bitmap as bm
from ..format.bmsparse import BmSparse
from ..utils.timing import PhaseTimer

_NUMERIC_CHUNK = 1 << 16  # tasks per scan step in the numeric phase


def _check_operands(a: BmSparse, b: BmSparse) -> None:
    if a.num_cols != b.num_rows:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if a.transposed:
        raise ValueError("A must be stored untransposed (row-major blocks)")
    # B may be stored either way; transposed is the fast layout the
    # reference uses (ref: src/bmSparse_SPGEMM.cu:1262), but decompression
    # normalizes, so both work.


# ---------------------------------------------------------------------------
# T1 + T2: task counting
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("num_b_block_rows",))
def _task_counts(a: BmSparse, b: BmSparse, num_b_block_rows: int):
    """Per-A-block task counts + exclusive offsets + total (traced).

    B's per-row start positions come from a positional segment_min rather
    than a cumsum of counts, so B may contain padding blocks *between*
    row groups (as produced by the multi-chip all-gather halo exchange) —
    the only requirement is that each block-row's valid blocks are
    contiguous and stored in intra-row sorted order.
    """
    b_valid = ((b.bmp_hi | b.bmp_lo) != 0).astype(jnp.int32)
    b_row_count = jax.ops.segment_sum(
        b_valid, b.brow, num_segments=num_b_block_rows
    )                                                   # T1
    pos = jnp.arange(b.nb_pad, dtype=jnp.int32)
    b_row_start = jax.ops.segment_min(
        jnp.where(b_valid > 0, pos, jnp.int32(2**31 - 1)),
        b.brow,
        num_segments=num_b_block_rows,
    )
    a_valid = (a.bmp_hi | a.bmp_lo) != 0
    bcol = jnp.clip(a.bcol, 0, num_b_block_rows - 1)
    cnt = jnp.where(a_valid, jnp.take(b_row_count, bcol), 0)  # T2
    offs = jnp.cumsum(cnt) - cnt
    total = offs[-1] + cnt[-1] if cnt.shape[0] else jnp.int32(0)
    return cnt.astype(jnp.int32), offs.astype(jnp.int32), b_row_start.astype(jnp.int32), total


# ---------------------------------------------------------------------------
# T3 + T4 + T5: task list construction, pruning, sort by C key
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("num_tasks", "c_row_sentinel"))
def _build_tasks(
    a: BmSparse,
    b: BmSparse,
    task_offs: jax.Array,
    b_row_start: jax.Array,
    total: jax.Array,
    num_tasks: int,
    c_row_sentinel: int,
):
    """Materialize the (padded) task list sorted by C key, pruned tasks and
    padding at the tail.

    Returns (a_idx, b_idx, ck_row, ck_col, ph, pl, nz_total) where task t
    multiplies A block a_idx[t] by B block b_idx[t] into C block
    (ck_row, ck_col)[t] with structural product bitmap (ph, pl)[t].
    Tasks with an all-zero structural product (pruned by the reference's
    multiplication_checker) and padding tasks carry ck_row == sentinel and
    sort last; nz_total counts surviving tasks.
    """
    t = jnp.arange(num_tasks, dtype=jnp.int32)
    valid = t < total
    # T3: expand every per-A-block quantity to its task span in ONE
    # jnp.repeat over stacked fields (no searchsorted, no scatter).
    nbr_b = b_row_start.shape[0]
    start_per_blk = jnp.take(
        b_row_start, jnp.clip(a.bcol, 0, nbr_b - 1)
    )  # nb-sized gather (cheap)
    counts = jnp.concatenate(
        [task_offs[1:] - task_offs[:-1], (total - task_offs[-1])[None]]
    ).astype(jnp.int32)
    fields = jnp.stack(
        [
            jnp.arange(a.nb_pad, dtype=jnp.int32),  # -> a_idx
            task_offs,                              # -> off_t
            start_per_blk,                          # -> b row start
            a.bmp_hi.astype(jnp.int32),             # -> task A bitmap hi
            a.bmp_lo.astype(jnp.int32),             # -> task A bitmap lo
            a.brow,                                 # -> task C block-row
            jnp.zeros((a.nb_pad,), jnp.int32),
            jnp.zeros((a.nb_pad,), jnp.int32),
        ],
        axis=1,
    )                                           # (nb, 8)
    c = jnp.repeat(
        fields, counts, axis=0, total_repeat_length=num_tasks
    )                                           # (nt, 8)
    a_idx = jnp.clip(c[:, 0], 0, a.nb_pad - 1)
    within = t - c[:, 1]
    b_idx = jnp.clip(c[:, 2] + within, 0, b.nb_pad - 1)
    a_hi = c[:, 3].astype(jnp.uint32)
    a_lo = c[:, 4].astype(jnp.uint32)
    a_row = c[:, 5]

    # B-side fields in one packed row-gather (per-row cost, not per-field).
    b_tbl = jnp.stack(
        [
            b.bmp_hi.astype(jnp.int32),
            b.bmp_lo.astype(jnp.int32),
            b.bcol,
            jnp.zeros_like(b.bcol),
        ],
        axis=1,
    )                                                    # (nb, 4)
    b_rows = jnp.take(b_tbl, b_idx, axis=0)              # (nt, 4)
    b_hi = b_rows[:, 0].astype(jnp.uint32)
    b_lo = b_rows[:, 1].astype(jnp.uint32)
    b_col = b_rows[:, 2]

    # T4: structural block product (bmp_calculator); zero product => prune.
    ph, pl = bm.bitmap_product(a_hi, a_lo, b_hi, b_lo,
                               b_transposed=b.transposed)
    alive = valid & ((ph | pl) != 0)
    ph = jnp.where(alive, ph, 0)
    pl = jnp.where(alive, pl, 0)

    # C key (task_elem_to_C_key, ref :111-119): (A block-row, B block-col).
    ck_row = jnp.where(alive, a_row, jnp.int32(c_row_sentinel))
    ck_col = jnp.where(alive, b_col, jnp.int32(0))
    # Cluster dead/padding tasks at the top block index so the sorted tail
    # keeps tight index spans (their products are zero anyway).
    a_idx = jnp.where(alive, a_idx, jnp.int32(a.nb_pad - 1))
    b_idx = jnp.where(alive, b_idx, jnp.int32(b.nb_pad - 1))

    # T5: single lexicographic sort replaces thrust::sort/bb_segsort; the
    # task product bitmaps ride along so T6 never regathers blocks.
    # (ops/segsort.py is the public sort surface — the segmented variant
    # is this same lex sort with the segment id as leading key.)
    from .segsort import sort_by_key

    ck_row, ck_col, a_idx, b_idx, ph, pl = sort_by_key(
        ck_row, ck_col, a_idx, b_idx,
        ph.astype(jnp.int32), pl.astype(jnp.int32),
        num_keys=2,
    )
    nz_total = jnp.sum(alive.astype(jnp.int32))
    return (a_idx, b_idx, ck_row, ck_col,
            ph.astype(jnp.uint32), pl.astype(jnp.uint32), nz_total)


# ---------------------------------------------------------------------------
# T6: C symbolic structure from the sorted task list
# ---------------------------------------------------------------------------
_SCAN_W = 128   # local-scan tile width
_I32_MAX = jnp.int32(2**31 - 1)


def _scan_combine(op: str, a, b, m):
    """Fold rolled-in values b into a where mask m (else identity)."""
    if op == "or":
        return a | jnp.where(m, b, 0)
    if op == "min":
        return jnp.minimum(a, jnp.where(m, b, _I32_MAX))
    return jnp.maximum(a, jnp.where(m, b, jnp.int32(-(2**31))))


def _seg_scan_2level(seg: jax.Array, vals: list) -> list:
    """Inclusive segmented scan of several arrays in two levels.

    vals: list of (int32 array, op) with op in {"or","min","max"}.
    seg must be non-decreasing segment ids; lengths a multiple of 128.

    Replaces a flat Hillis-Steele scan (log2(nt) rolls over the FULL
    arrays): level 1 runs 7 Hillis-Steele steps as rotations inside
    (nt/128, 128) rows; level 2 resolves cross-row carries with a
    segmented scan over only nt/128 row summaries. Matches the
    reference's one-pass reduce_by_key semantics for segment aggregates
    (ref: src/bmSparse_SPGEMM.cu:1031-1083) at end positions.
    """
    nt = seg.shape[0]
    W = _SCAN_W
    R = nt // W
    seg2 = seg.reshape(R, W)
    arrs = [v.reshape(R, W) for v, _ in vals]
    ops = [op for _, op in vals]
    lane = jax.lax.broadcasted_iota(jnp.int32, (R, W), 1)
    sh = 1
    while sh < W:
        m = (lane >= sh) & (jnp.roll(seg2, sh, axis=1) == seg2)
        arrs = [
            _scan_combine(op, a, jnp.roll(a, sh, axis=1), m)
            for a, op in zip(arrs, ops)
        ]
        sh *= 2
    # cross-row carries: c[r] = last[r] op (c[r-1] if row r is entirely
    # the segment that ended row r-1) — a segmented scan over R elements
    seg_first = seg2[:, 0]
    seg_last = seg2[:, -1]
    prev_last = jnp.roll(seg_last, 1)
    riota = jnp.arange(R, dtype=jnp.int32)
    link = (riota > 0) & (seg_first == seg_last) & (seg_first == prev_last)
    carry_seg = jnp.cumsum(1 - link.astype(jnp.int32))
    lasts = [a[:, -1] for a in arrs]
    sh = 1
    while sh < R:
        m = (riota >= sh) & (jnp.roll(carry_seg, sh) == carry_seg)
        lasts = [
            _scan_combine(op, c, jnp.roll(c, sh), m)
            for c, op in zip(lasts, ops)
        ]
        sh *= 2
    # apply the previous row's carry to this row's head segment
    applies = (riota[:, None] > 0) & (seg2 == prev_last[:, None])
    outs = []
    for a, c, op in zip(arrs, lasts, ops):
        cprev = jnp.broadcast_to(jnp.roll(c, 1)[:, None], a.shape)
        outs.append(_scan_combine(op, a, cprev, applies).reshape(nt))
    return outs


@partial(jax.jit, static_argnames=("c_row_sentinel",))
def _c_symbolic_scan(
    ph: jax.Array, pl: jax.Array,
    ck_row: jax.Array, ck_col: jax.Array,
    c_row_sentinel: int,
    a_idx: jax.Array | None = None,
    b_idx: jax.Array | None = None,
):
    """Task-space C structure via a two-level segmented scan — the
    host-path replacement for _c_symbolic's expand+segment-sum (no
    per-task scatters; the two-level scan is 7 roll passes plus an
    nt/128-sized carry scan instead of log2(nt) full passes).

    Everything stays in TASK space: the OR of each C block's product
    bitmaps and its exclusive value offset sit at the block's LAST task
    position; the device planner (_plan_sell_device) builds the
    end-position index that compacts them.

    Returns (c_seg, keys_tbl, nbc, nnzc) where keys_tbl is the (nt, 11)
    int32 row table [ck_row, ck_col, hi, lo, off, cnt, a_idx, b_idx,
    amin, bmin, bmax] for row-granular gathers: columns 0-5 and 8-10 are
    segment-level results valid at end positions (8-10 are the operand
    index spans that drive the windowed-gather planner), columns 6-7
    per-task operands used by the slot gather.
    """
    nt = ph.shape[0]
    pad = (-nt) % _SCAN_W
    if pad:
        # tiny inputs: pad into a private trailing segment
        ph = jnp.concatenate([ph, jnp.zeros((pad,), ph.dtype)])
        pl = jnp.concatenate([pl, jnp.zeros((pad,), pl.dtype)])
        ck_row = jnp.concatenate(
            [ck_row, jnp.full((pad,), c_row_sentinel, jnp.int32)])
        ck_col = jnp.concatenate([ck_col, jnp.zeros((pad,), jnp.int32)])
        if a_idx is not None:
            a_idx = jnp.concatenate([a_idx, jnp.zeros((pad,), jnp.int32)])
        if b_idx is not None:
            b_idx = jnp.concatenate([b_idx, jnp.zeros((pad,), jnp.int32)])
    ntp = nt + pad
    alive = ck_row != c_row_sentinel
    same = (ck_row[1:] == ck_row[:-1]) & (ck_col[1:] == ck_col[:-1])
    new = jnp.concatenate(
        [jnp.ones((1,), jnp.int32), 1 - same.astype(jnp.int32)]
    )
    c_seg = jnp.cumsum(new) - 1
    nbc = jnp.max(jnp.where(alive, c_seg + 1, 0)) if ntp else jnp.int32(0)

    vals = [(ph.astype(jnp.int32), "or"), (pl.astype(jnp.int32), "or")]
    if a_idx is not None:
        vals.append((a_idx.astype(jnp.int32), "min"))   # amin (a_idx is
        # non-decreasing inside a segment, so min == first)
    if b_idx is not None:
        vals.append((b_idx.astype(jnp.int32), "min"))
        vals.append((b_idx.astype(jnp.int32), "max"))
    outs = _seg_scan_2level(c_seg, vals)
    hi = outs[0].astype(jnp.uint32)
    lo = outs[1].astype(jnp.uint32)

    is_end = jnp.concatenate(
        [c_seg[1:] != c_seg[:-1], jnp.ones((1,), bool)]
    ) & alive
    cnt = jnp.where(is_end, bm.popcount(hi, lo), 0)
    csum = jnp.cumsum(cnt)
    off_task = (csum - cnt).astype(jnp.int32)
    nnzc = csum[-1] if ntp else jnp.int32(0)
    zeros = jnp.zeros((ntp,), jnp.int32)
    keys_tbl = jnp.stack(
        [
            ck_row, ck_col,
            hi.astype(jnp.int32), lo.astype(jnp.int32),
            off_task, cnt.astype(jnp.int32),
            zeros if a_idx is None else a_idx.astype(jnp.int32),
            zeros if b_idx is None else b_idx.astype(jnp.int32),
            zeros if a_idx is None else outs[2],
            zeros if b_idx is None else outs[-2],
            zeros if b_idx is None else outs[-1],
        ],
        axis=1,
    )
    if pad:
        c_seg = c_seg[:nt]
        keys_tbl = keys_tbl[:nt]
    return c_seg, keys_tbl, nbc, nnzc


@partial(jax.jit, static_argnames=("c_row_sentinel",))
def _c_symbolic(
    ph: jax.Array, pl: jax.Array,
    ck_row: jax.Array, ck_col: jax.Array,
    c_row_sentinel: int,
):
    """C block keys, bitmaps, offsets from sorted tasks (with their
    structural product bitmaps ph/pl from _build_tasks).

    Returns (c_seg, cbrow, cbcol, c_hi, c_lo, c_offsets, nbc, nnzc); arrays
    sized num_tasks (an upper bound on C's block count), padding past nbc.
    """
    nt = ck_row.shape[0]
    alive = ck_row != c_row_sentinel
    same = (ck_row[1:] == ck_row[:-1]) & (ck_col[1:] == ck_col[:-1])
    new = jnp.concatenate(
        [jnp.ones((1,), jnp.int32), 1 - same.astype(jnp.int32)]
    )
    # Dead/padding tasks share the sentinel key and collapse into one
    # trailing segment; exclude them from the block count.
    c_seg = jnp.cumsum(new) - 1
    nbc = jnp.max(jnp.where(alive, c_seg + 1, 0)) if nt else jnp.int32(0)

    # one 2-wide row scatter instead of two scalar scatters
    keypair = jnp.stack([ck_row, ck_col], axis=1)            # (nt, 2)
    ckeys = (
        jnp.tile(jnp.array([[c_row_sentinel, 0]], jnp.int32), (nt, 1))
        .at[c_seg].set(keypair)
    )
    cbrow = ckeys[:, 0]
    cbcol = ckeys[:, 1]

    # C bitmap = OR over the segment's task products (bmp_calculator +
    # bmp_sum reduce_by_key, ref :1067-1083). Dead tasks carry zero
    # bitmaps, so a plain segmented OR is exact. OR on packed u32 words:
    # segment_max of each word... bitwise OR isn't max; use the bit-plane
    # trick: OR == (segment_sum of expanded bits) > 0, row-granular.
    bits = bm.expand_bits(ph, pl)                       # (nt, 64)
    c_bits = (
        jax.ops.segment_sum(bits, c_seg, num_segments=nt) > 0
    ).astype(jnp.int32)
    c_hi, c_lo = bm.pack_bits(c_bits)

    # offsets / nnz (popcount + exclusive_scan, ref :1086-1107).
    cnt = jnp.sum(c_bits, axis=1, dtype=jnp.int32)
    c_offsets = (jnp.cumsum(cnt) - cnt).astype(jnp.int32)
    nnzc = c_offsets[-1] + cnt[-1] if nt else jnp.int32(0)
    c_offsets = jnp.where(
        jnp.arange(nt) < nbc, c_offsets, jnp.maximum(nnzc - 1, 0)
    ).astype(jnp.int32)
    return c_seg, cbrow, cbcol, c_hi, c_lo, c_offsets, nbc, nnzc


# ---------------------------------------------------------------------------
# Numeric phase — task-SELL layout (the fast path)
# ---------------------------------------------------------------------------
# The reference's numeric kernels walk each C block's task span with a warp
# (ref: src/bmSparse_SPGEMM.cu:205-733). Here the C block sits on a
# 128-wide axis: C blocks are sigma-sorted by task count, grouped into
# chunks of 128, and each chunk padded to its (bucketed) max task count K.
# The per-C-block accumulation is then a dense sum over the K axis — no
# segment_sum. A/B tiles are gathered from transposed (64, nb+1) tables
# (XLA) or from row-major tables inside the fused Triton kernel
# (ops/pallas/spgemm_kernel.py).

_SELL_SLAB = 64          # chunks per scan slab (bounds gather transients)
_K_BUCKETS = tuple(
    sorted({1, 2, 3} | {m for b in range(2, 21) for m in ((1 << b), 3 << (b - 1))})
)


def _bucket_k(k: int) -> int:
    for b in _K_BUCKETS:
        if b >= k:
            return b
    return k


@partial(jax.jit, static_argnames=("nbc_pad",))
def _plan_sell_device(
    c_seg: jax.Array, num_alive: jax.Array, nbc: jax.Array, nbc_pad: int,
    keys_tbl: jax.Array | None = None,
):
    """Device-side numeric plan (no host-numpy planning).

    Everything is sort/cumsum arithmetic — CARRYING sorts, never
    gathers of the multi-million-block per-block tables. Steps:

      1. each C block's LAST task position ("end") is extracted with ONE
         lax.sort keyed on the end-flagged segment id that CARRIES the
         per-task scan columns (bitmaps, offsets, keys, operand spans) —
         the sorted prefix IS the natural-order block table;
      2. per-block task counts/starts are differences of ends;
      3. ONE second sort keyed (bucketed count desc, amin asc, ordinal)
         produces the SELL-sigma order AND the in-K-group
         window-locality permutation together, again carrying the
         per-block columns (sigma compress tables come out for free).
         Block-granular: sigma count classes restart natural order at
         every class boundary, so any chunk-level permutation leaves
         full-table spans in the straddling chunk.

    nbc_pad must be a multiple of 128; keys_tbl is the (nt, 11) scan
    table. Returns (starts_sig, ends_sig, cnt_sig, nat_of_sig, k_chunk,
    stats, nat_cols, sig_cols): stats = per-chunk (amin, amax, bmin,
    bmax); nat_cols = natural-order (ck_row, ck_col, hi, lo, off);
    sig_cols = sigma-order (hi, lo, off) for the compress tables.
    """
    nt = c_seg.shape[0]
    t = jnp.arange(nt, dtype=jnp.int32)
    alive = t < num_alive
    is_end = alive & jnp.concatenate(
        [c_seg[1:] != c_seg[:-1], jnp.ones((1,), bool)]
    )
    big = jnp.int32(2**30)
    key = jnp.where(is_end, c_seg, big)
    carry_cols = [keys_tbl[:, i] for i in (0, 1, 2, 3, 4, 6, 8, 9, 10)]
    sorted_all = jax.lax.sort((key, t, *carry_cols), num_keys=1)
    ends_all = sorted_all[1]
    nat_all = sorted_all[2:]

    def fit(x):
        if nt >= nbc_pad:
            return x[:nbc_pad]
        return jnp.concatenate(
            [x, jnp.zeros((nbc_pad - nt,), jnp.int32)])

    ends = fit(ends_all)
    (nat_ckr, nat_ckc, nat_hi, nat_lo, nat_off,
     nat_amax, nat_amin, nat_bmin, nat_bmax) = (fit(x) for x in nat_all)
    b_iota = jnp.arange(nbc_pad, dtype=jnp.int32)
    validb = b_iota < nbc
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), ends[:-1] + 1])
    counts = jnp.where(validb, ends - starts + 1, 0)

    # per-block bucketed depth (bucket is monotone, so chunk-max of
    # per-block buckets == bucket of chunk-max counts — identical K
    # padding to per-chunk bucketing). Select ladder, not searchsorted +
    # take: 40 fused selects are one streaming pass, with no gather.
    buckets = jnp.asarray(_K_BUCKETS, jnp.int32)

    def bucket_ceil(c):
        cb = c
        for b in reversed(_K_BUCKETS):
            cb = jnp.where(c <= b, jnp.int32(b), cb)
        return cb

    kb_blk = jnp.where(counts > 0, bucket_ceil(counts), 0).astype(jnp.int32)
    amin_key = jnp.where(counts > 0, nat_amin, big)
    amax_m = jnp.where(counts > 0, nat_amax, -1)
    bmin_m = jnp.where(counts > 0, nat_bmin, big)
    bmax_m = jnp.where(counts > 0, nat_bmax, -1)

    # Class-aligned sigma padding: route the planner's padding blocks
    # (counts == 0) to the END of each count class so every class
    # occupies a 128-multiple of slots and no chunk straddles two
    # classes. Without this, the one straddling chunk per class boundary
    # spans the WHOLE operand table (the next class restarts amin near
    # 0) and — because the window width is the max over a group's slabs
    # — disables the windowed gather for the entire K-group. Padding
    # lands after all real blocks of its class via amin = big; classes
    # beyond the
    # bucket list (raw counts > _K_BUCKETS[-1]) get no padding and
    # degrade to the old straddle, as does a plan whose padding slots
    # run out (nbc_pad - nbc < total needed) — correctness is
    # unaffected either way, only window engagement.
    buckets_desc = buckets[::-1]
    sizes = jnp.sum(
        kb_blk[None, :] == buckets_desc[:, None], axis=1,
        dtype=jnp.int32)                                  # (n_buckets,)
    pc = jnp.where(sizes > 0, (-sizes) % 128, 0)
    cumi = jnp.cumsum(pc)                                 # inclusive
    jpad = b_iota - nbc                                   # <0 for real
    cls_idx = jnp.sum(
        jpad[:, None] >= cumi[None, :], axis=1, dtype=jnp.int32)
    # select ladder for the same reason as bucket_ceil above
    kb_pad = jnp.zeros_like(cls_idx)
    for i in range(len(_K_BUCKETS)):
        kb_pad = jnp.where(
            cls_idx == i,
            jnp.int32(_K_BUCKETS[len(_K_BUCKETS) - 1 - i]), kb_pad)
    key_kb = jnp.where(counts > 0, kb_blk, jnp.where(jpad >= 0, kb_pad, 0))

    # Secondary key: NATURAL block id — inside a class the stacked rows
    # keep natural order, so sig_off is non-decreasing per class. Real
    # padding still lands at its class END (its b_iota >= nbc).
    (_, _, amin_s, starts_sig, ends_sig, cnt_sig, nat_of_sig,
     sig_hi, sig_lo, sig_off, amax_s, bmin_s, bmax_s) = jax.lax.sort(
        (-key_kb, b_iota,
         amin_key,
         starts, ends, counts, b_iota,
         nat_hi, nat_lo, nat_off, amax_m, bmin_m, bmax_m),
        num_keys=2,
    )
    # zero-count (padding) blocks carried garbage columns through the
    # sort tail — zero them so compress packs nothing for those rows
    okb = cnt_sig > 0
    sig_hi = jnp.where(okb, sig_hi, 0)
    sig_lo = jnp.where(okb, sig_lo, 0)
    sig_off = jnp.where(okb, sig_off, 0)
    nchunk = nbc_pad // 128
    k_raw = jnp.max(cnt_sig.reshape(nchunk, 128), axis=1)
    k_chunk = jnp.where(
        k_raw > 0, bucket_ceil(k_raw), 0
    ).astype(jnp.int32)
    amin_c = jnp.min(amin_s.reshape(nchunk, 128), axis=1)
    amax_c = jnp.max(amax_s.reshape(nchunk, 128), axis=1)
    bmin_c = jnp.min(bmin_s.reshape(nchunk, 128), axis=1)
    bmax_c = jnp.max(bmax_s.reshape(nchunk, 128), axis=1)
    return (
        starts_sig, ends_sig, cnt_sig, nat_of_sig, k_chunk,
        (amin_c, amax_c, bmin_c, bmax_c),
        (nat_ckr, nat_ckc, nat_hi, nat_lo, nat_off),
        (sig_hi, sig_lo, sig_off),
    )


@partial(jax.jit, static_argnames=("ch_pad", "k"))
def _gather_group_slots(
    keys_tbl: jax.Array,
    starts_sig: jax.Array, cnt_sig: jax.Array,
    c0: jax.Array, ch_pad: int, k: int,
    sent_a: int, sent_b: int,
):
    """Slot operand indices for one K-group as a row-gather.

    Returns (ta, tb) of shape (ch_pad, k, 128): slot (c, k, lane) holds
    the A/B block indices of sigma block (c0 + c)*128 + lane's k-th task
    (sentinels past the block's count). keys_tbl columns 6/7 carry the
    per-task a_idx/b_idx (see _c_symbolic_scan)."""
    nt = keys_tbl.shape[0]
    npad = ch_pad * 128
    ssz = starts_sig.shape[0]
    pad = jnp.zeros((npad,), jnp.int32)
    st_ext = jnp.concatenate([starts_sig, pad])
    cn_ext = jnp.concatenate([cnt_sig, pad])
    base = jnp.clip(c0 * 128, 0, ssz)
    st = jax.lax.dynamic_slice(st_ext, (base,), (npad,)).reshape(
        ch_pad, 1, 128
    )
    cn = jax.lax.dynamic_slice(cn_ext, (base,), (npad,)).reshape(
        ch_pad, 1, 128
    )
    k_iota = jnp.arange(k, dtype=jnp.int32)[None, :, None]
    idx = jnp.where(k_iota < cn, st + k_iota, nt)
    sent_row = jnp.asarray([[sent_a, sent_b]], jnp.int32)
    tbl = jnp.concatenate([keys_tbl[:, 6:8], sent_row], axis=0)
    rows = jnp.take(tbl, idx.reshape(-1), axis=0, mode="clip")
    ta = rows[:, 0].reshape(ch_pad, k, 128)
    tb = rows[:, 1].reshape(ch_pad, k, 128)
    return ta, tb


def _slab_from_gathered(ga, gb, k: int):
    """Block products + K-sum for gathered operands (s, k, 128, 64) ->
    (s*128, 64) row-major C tiles. Slot layouts [i*8+j] for A, [j*8+m]
    for B (both row-major); products/accumulation f32 (bf16 operand casts
    fuse into the FMA chain)."""
    s = ga.shape[0]
    ga = jnp.moveaxis(ga, 2, 3).reshape(s, k, 8, 8, 128)  # [., ., i, j, lane]
    gb = jnp.moveaxis(gb, 2, 3).reshape(s, k, 8, 8, 128)  # [., ., j, m, lane]
    acc_dt = jnp.promote_types(ga.dtype, jnp.float32)     # bf16 -> f32, f64 stays
    acc = jnp.zeros((s, k, 8, 8, 128), acc_dt)
    for j in range(8):
        acc = acc + (
            ga[:, :, :, j, None, :].astype(acc_dt)
            * gb[:, :, None, j, :, :].astype(acc_dt)
        )
    csum = jnp.sum(acc, axis=1)                          # (s, 8, 8, 128)
    return jnp.transpose(csum, (0, 3, 1, 2)).reshape(s * 128, 64)


@partial(jax.jit, static_argnames=("k",))
def _numeric_sell_slab(a_t, b_t, ta, tb, k: int):
    """Products for (s, k, 128) task slots -> (s*128, 64) row-major tiles.

    a_t/b_t: (64, nb+1) transposed dense tiles with a zero sentinel
    column.
    """
    ga = jnp.moveaxis(jnp.take(a_t, ta, axis=1), 0, 3)   # (s, k, 128, 64)
    gb = jnp.moveaxis(jnp.take(b_t, tb, axis=1), 0, 3)
    return _slab_from_gathered(ga, gb, k)


def _slab_chunks(ch: int, k: int) -> int:
    """Chunks per scan slab for a (ch, k)-shaped K-group — shared by the
    numeric scan and the host window planner (their slab partitions must
    agree exactly)."""
    if ch <= _SELL_SLAB or ch * k * 128 <= _SELL_SLAB * 128 * 8:
        return ch
    return max(1, min(_SELL_SLAB, (1 << 16) // max(k, 1)))


def _numeric_sell_group(a_t, b_t, ta, tb) -> jax.Array:
    """One K-group, scanned in slabs to bound gather transients
    (full-table lane gathers; see _numeric_group_windowed for the
    windowed variant that large operand tables route through)."""
    ch, k, _ = ta.shape
    slab = _slab_chunks(ch, k)
    if slab == ch:
        return _numeric_sell_slab(a_t, b_t, ta, tb, k)
    nsl = -(-ch // slab)
    pad = nsl * slab - ch
    if pad:
        sa = jnp.full((pad, k, 128), a_t.shape[1] - 1, jnp.int32)
        sb = jnp.full((pad, k, 128), b_t.shape[1] - 1, jnp.int32)
        ta = jnp.concatenate([ta, sa])
        tb = jnp.concatenate([tb, sb])
    ta = ta.reshape(nsl, slab, k, 128)
    tb = tb.reshape(nsl, slab, k, 128)

    def step(_, ab):
        return 0, _numeric_sell_slab(a_t, b_t, ab[0], ab[1], k)

    _, out = jax.lax.scan(step, 0, (ta, tb))
    return out.reshape(nsl * slab * 128, 64)[: ch * 128]


def _win_gather(ext, idx_flat, w: int, start):
    """Gather rows of ext ((nb+1, 64) row-major, zero sentinel row last)
    at idx_flat, through a w-row window starting at `start` when w > 0.

    The window is one contiguous dynamic_slice (a straight copy) + a
    relative take, so every gather reads a small table however large
    the operand table is. The planner guarantees every real index lands
    inside the window (spans measured at plan time); the sentinel maps
    to the window's own zero row."""
    nbt = ext.shape[0] - 1
    if w == 0:
        return jnp.take(ext, idx_flat, axis=0)
    win = jax.lax.dynamic_slice(ext, (start, 0), (w, 64))
    win = jnp.concatenate([win, jnp.zeros((1, 64), ext.dtype)])
    rel = jnp.where(idx_flat >= nbt, w, idx_flat - start)
    return jnp.take(win, rel, axis=0)


def _numeric_group_windowed(
    a_ext, b_ext, ta, tb, k: int, wa: int, wb: int, sa_arr, sb_arr
):
    """One K-group with per-slab windowed operand gathers.

    a_ext/b_ext: (nb+1, 64) row-major dense tiles (zero sentinel row).
    sa_arr/sb_arr: (nsl,) per-slab window starts (plan data; chunks were
    permuted by min operand index at plan time so slab spans are tight).
    wa/wb = 0 disables windowing for that side (full-table row gathers).
    """
    ch, _, _ = ta.shape
    slab = _slab_chunks(ch, k)
    nsl = -(-ch // slab)
    pad = nsl * slab - ch
    if pad:
        fa = jnp.full((pad, k, 128), a_ext.shape[0] - 1, jnp.int32)
        fb = jnp.full((pad, k, 128), b_ext.shape[0] - 1, jnp.int32)
        ta = jnp.concatenate([ta, fa])
        tb = jnp.concatenate([tb, fb])
    ta = ta.reshape(nsl, slab, k, 128)
    tb = tb.reshape(nsl, slab, k, 128)

    def step(_, x):
        ta_s, tb_s, sa, sb = x
        ga = _win_gather(a_ext, ta_s.reshape(-1), wa, sa)
        gb = _win_gather(b_ext, tb_s.reshape(-1), wb, sb)
        return 0, _slab_from_gathered(
            ga.reshape(slab, k, 128, 64), gb.reshape(slab, k, 128, 64), k
        )

    if nsl == 1:
        _, out = step(0, (ta[0], tb[0], sa_arr[0], sb_arr[0]))
        return out[: ch * 128]
    _, out = jax.lax.scan(step, 0, (ta, tb, sa_arr, sb_arr))
    return out.reshape(nsl * slab * 128, 64)[: ch * 128]


def _contiguous_k_groups(kc) -> list:
    """(K, c0, c1) triples over the non-increasing per-chunk depth array
    (0-depth chunks are empty and dropped)."""
    groups = []
    c0 = 0
    n = len(kc)
    while c0 < n and kc[c0] > 0:
        c1 = c0
        while c1 < n and kc[c1] == kc[c0]:
            c1 += 1
        groups.append((int(kc[c0]), c0, c1))
        c0 = c1
    return groups


def _numeric_group(a_ext, b_ext, ta, tb, impl: str) -> jax.Array:
    """One K-group's (ch*128, 64) C tiles from full operand tables.

    a_ext/b_ext: (nb+1, 64) row-major dense tiles, zero sentinel row last.
    impl "pallas" runs the fused Triton kernel (ops/pallas/spgemm_kernel.py);
    anything else the XLA lane-gather formulation."""
    if impl == "pallas":
        from .pallas.spgemm_kernel import numeric_sell_triton

        return numeric_sell_triton(a_ext, b_ext, ta, tb)
    return _numeric_sell_group(a_ext.T, b_ext.T, ta, tb)


def _numeric_sell_parts(
    a_flat, b_flat, tas: tuple, tbs: tuple,
    groups: list, impl: str,
    win: tuple = (), win_starts: tuple = (),
):
    """Run the task-SELL products over all K-groups from the cached slot
    tables (tas/tbs are PLAN data — built once per structure, not per
    multiply).

    win[i] = (wa, wb) static window row counts of the XLA slab-window
    path (0 = no window); win_starts[i] = (sa_arr, sb_arr) per-slab start
    rows. The Triton kernel (impl "pallas") reads the full tables and
    ignores the windows.

    Returns c_rows: stacked (R, 64) dense C tiles in sigma group order.
    """
    # keep the operand dtype (bf16 tiles halve gather traffic; products
    # accumulate f32 downstream)
    a_ext = jnp.concatenate([a_flat, jnp.zeros((1, 64), a_flat.dtype)])
    b_ext = jnp.concatenate([b_flat, jnp.zeros((1, 64), b_flat.dtype)])
    if impl == "pallas" or not win:
        win = ((0, 0),) * len(groups)
    parts = []
    for gi, (kg, c0, c1) in enumerate(groups):
        ta, tb = tas[gi], tbs[gi]
        wa, wb = win[gi]
        if wa or wb:
            sa_arr, sb_arr = win_starts[gi]
            parts.append(_numeric_group_windowed(
                a_ext, b_ext, ta, tb, kg, wa, wb, sa_arr, sb_arr))
        else:
            parts.append(_numeric_group(a_ext, b_ext, ta, tb, impl))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


@partial(jax.jit, static_argnames=("num_c_nnz",))
def _compress_rows(
    c_rows: jax.Array,
    hi: jax.Array, lo: jax.Array, off: jax.Array,
    num_c_nnz: int,
) -> jax.Array:
    """Pack dense C tiles into bit-order values; hi/lo/off are row-aligned
    with c_rows (any order; rows with zero bitmaps contribute nothing).

    Everything here is row-granular rather than a per-element scatter:
    each block's packed values occupy positions [off, off+cnt) which
    touch at most TWO 64-wide output rows (cnt <= 64) = ONE scattered
    128-wide row. See _pack_rows/_compress_core for the stages.
    """
    return _compress_core(c_rows, hi, lo, off, num_c_nnz)


def _pack_rows(c_rows, hi, lo, off):
    """Per-block bit-order packing: returns (w, b_row) where w (R, 128)
    holds each block's packed values rotated to their output lane
    positions (lanes [0,64) belong to output row b_row, lanes [64,128) to
    row b_row + 1).

    One STABLE 64-lane sort keyed on the unset flag packs the set-bit
    values to the front in slot order — stability IS the rank, so no
    prefix-popcount is needed (saves an expand+cumsum pass); one
    variable right-rotation by off%64 then
    holds BOTH parts: lanes [r, 64) carry the first-row values, wrapped
    lanes [0, cnt+r-64) carry the next-row values.
    """
    bits = bm.expand_bits(hi, lo)                       # (R, 64)
    r = (off % 64)[:, None].astype(jnp.int32)
    set_ = bits > 0
    lane = jnp.arange(64, dtype=jnp.int32)[None, :]
    key = 1 - set_.astype(jnp.int32)
    _, packed = jax.lax.sort((key, c_rows), dimension=1, num_keys=1)
    cnt = jnp.sum(set_, axis=1, dtype=jnp.int32)[:, None]
    packed = jnp.where(lane < cnt, packed, 0.0)
    for k in range(6):                # conditional rolls: rotate right by r
        rolled = jnp.roll(packed, 1 << k, axis=1)
        packed = jnp.where((r >> k) & 1 > 0, rolled, packed)
    v0 = jnp.where((lane >= r) & (lane < r + cnt), packed, 0.0)
    v1 = jnp.where(lane < cnt + r - 64, packed, 0.0)
    w = jnp.concatenate([v0, v1], axis=1)                # (R, 128)
    return w, (off // 64).astype(jnp.int32)


def _fold_out(out128, t_rows: int, num_c_nnz: int) -> jax.Array:
    """Split 128-wide packed rows back into 64-lane output rows: row q's
    lanes [64,128) belong to output row q+1."""
    carry = jnp.concatenate(
        [jnp.zeros((1, 64), out128.dtype), out128[: t_rows - 1, 64:]]
    ) if t_rows > 1 else jnp.zeros((t_rows, 64), out128.dtype)
    out = out128[:t_rows, :64] + carry
    return out.reshape(-1)[:num_c_nnz]


def _compress_core(c_rows, hi, lo, off, num_c_nnz: int) -> jax.Array:
    w, b_row = _pack_rows(c_rows, hi, lo, off)
    t_rows = -(-num_c_nnz // 64) if num_c_nnz else 1
    # ONE 128-wide row scatter-add instead of two 64-wide ones; rows of
    # neighbouring blocks may overlap, so the adds can collide (the sum
    # order of colliding adds is unspecified on a GPU).
    out128 = jnp.zeros((t_rows + 1, 128), w.dtype).at[b_row].add(
        w, mode="drop"
    )
    return _fold_out(out128, t_rows, num_c_nnz)


@partial(jax.jit, static_argnames=("num_c_nnz",))
def _compress_fold(
    c_rows: jax.Array,
    hi: jax.Array, lo: jax.Array, off: jax.Array,
    g_tbl: jax.Array, num_c_nnz: int,
) -> jax.Array:
    """Gather-fold compress: the scatter-free alternative to
    _compress_rows' row scatter-add.

    g_tbl (t_rows, J) is plan data: row q lists the packed rows whose
    64-slot spans start inside output row q (offsets are contiguous in
    natural block order, so contributors form runs; out-of-range
    sentinels point at the appended zero row). out128[q] = sum of its
    contributors, then the standard 128->64 lane fold. Used when the
    plan measures J small (banded/dense structures); skewed structures
    (J large) keep the scatter."""
    w, _ = _pack_rows(c_rows, hi, lo, off)
    w_ext = jnp.concatenate([w, jnp.zeros((1, 128), w.dtype)])
    t_rows = -(-num_c_nnz // 64) if num_c_nnz else 1
    j_n = g_tbl.shape[1]
    # ONE fused gather for all J contributors (J separate takes each
    # materialize a (t_rows, 128) intermediate; fused, XLA emits one
    # gather + one reduce). mode="clip" skips take's default fill-select
    # pass — indices are already bounded by the min below.
    idx = jnp.minimum(g_tbl, w.shape[0]).reshape(-1)
    out128 = jnp.take(w_ext, idx, axis=0, mode="clip").reshape(
        -1, j_n, 128).sum(axis=1)
    return _fold_out(out128, t_rows, num_c_nnz)


@partial(jax.jit, static_argnames=("j_max", "t_rows_pad"))
def _compress_fold_plan(
    nat_off: jax.Array, nat_of_sig: jax.Array, chunk_base: jax.Array,
    nbc: jax.Array, j_max: int, t_rows_pad: int,
) -> jax.Array:
    """Build the (t_rows_pad, j_max) contributor table for _compress_fold.

    In natural block order offsets are a prefix sum, so the blocks whose
    packed values start inside output row q form one contiguous run;
    g[q, j] is the STACKED row (numeric output order) of the run's j-th
    block, found by mapping natural -> sigma (sort-inversion of
    nat_of_sig — sorts are cheap where scatters are not) -> stacked row
    (chunk_base, host data). Sentinels (2**30) mark absent contributors.
    """
    nbc_pad = nat_off.shape[0]
    big = jnp.int32(2**30)
    n_iota = jnp.arange(nbc_pad, dtype=jnp.int32)
    validb = n_iota < nbc
    # natural -> stacked numeric row
    _, sig_of = jax.lax.sort((nat_of_sig, n_iota), num_keys=1)
    srow = jnp.take(
        chunk_base, jnp.clip(sig_of // 128, 0, chunk_base.shape[0] - 1)
    ) + sig_of % 128
    # contributor runs over the monotone output-row ids
    b_row = jnp.where(validb, nat_off // 64, big)
    newr = jnp.concatenate(
        [jnp.ones((1,), bool), b_row[1:] != b_row[:-1]])
    keyq = jnp.where(validb & newr, b_row, big)
    _, firstn_all = jax.lax.sort((keyq, n_iota), num_keys=1)
    if nbc_pad >= t_rows_pad:
        first_q = firstn_all[:t_rows_pad]
    else:
        first_q = jnp.concatenate([
            firstn_all,
            jnp.full((t_rows_pad - nbc_pad,), nbc_pad, jnp.int32),
        ])
    j_iota = jnp.arange(j_max, dtype=jnp.int32)[None, :]
    nat_id = jnp.minimum(first_q[:, None] + j_iota, nbc_pad)
    b_row_ext = jnp.concatenate([b_row, jnp.full((1,), big, jnp.int32)])
    br = jnp.take(b_row_ext, nat_id)
    q_iota = jnp.arange(t_rows_pad, dtype=jnp.int32)[:, None]
    srow_ext = jnp.concatenate([srow, jnp.full((1,), big, jnp.int32)])
    return jnp.where(
        br == q_iota, jnp.take(srow_ext, nat_id), big
    ).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Numeric phase — chunked segment-sum path (jit-safe; shard_map uses this)
# ---------------------------------------------------------------------------
def _numeric_xla(
    a_flat: jax.Array, b_flat: jax.Array,
    a_idx: jax.Array, b_idx: jax.Array, c_seg: jax.Array,
    num_c_blocks: int,
):
    """Chunked batched 8x8 block products accumulated per C block.

    The analogue of multiplyV15's scalar FMA loop (ref :205-291):
    gather flat dense tiles, eight 64-wide multiply-accumulates per task
    (see format/blockops.py), segment-sum by C block. lax.scan over
    fixed-size task chunks bounds peak memory the way the reference's
    TASK_BUFFER staging does (ref :343,358). All intermediates are
    (n, 64), never (n, 8, 8).
    """
    from ..format.blockops import block_matmul_flat
    from .gather import gather_rows

    nt = a_idx.shape[0]
    chunk = min(_NUMERIC_CHUNK, nt)
    nchunks = -(-nt // chunk)
    pad = nchunks * chunk - nt
    if pad:
        a_idx = jnp.concatenate([a_idx, jnp.zeros((pad,), jnp.int32)])
        b_idx = jnp.concatenate([b_idx, jnp.zeros((pad,), jnp.int32)])
        # padding tasks dump into segment num_c_blocks (dropped)
        c_seg = jnp.concatenate(
            [c_seg, jnp.full((pad,), num_c_blocks, jnp.int32)]
        )
    a_idx = a_idx.reshape(nchunks, chunk)
    b_idx = b_idx.reshape(nchunks, chunk)
    c_seg = c_seg.reshape(nchunks, chunk)

    acc_dt = jnp.promote_types(a_flat.dtype, jnp.float32)

    def step(acc, operands):
        ai, bi, cs = operands
        blk_a = gather_rows(a_flat, ai)                     # (chunk, 64)
        blk_b = gather_rows(b_flat, bi)                     # (chunk, 64)
        contrib = block_matmul_flat(
            blk_a, blk_b, b_transposed=False, acc_dtype=acc_dt)
        acc = acc + jax.ops.segment_sum(
            contrib, cs, num_segments=num_c_blocks
        )
        return acc, None

    init = jnp.zeros((num_c_blocks, 64), acc_dt)
    if nchunks == 1:
        acc, _ = step(init, (a_idx[0], b_idx[0], c_seg[0]))
        return acc
    acc, _ = jax.lax.scan(step, init, (a_idx, b_idx, c_seg))
    return acc


@partial(
    jax.jit,
    static_argnames=("num_c_blocks", "num_c_nnz"),
)
def _numeric_and_compress(
    a_flat: jax.Array, b_flat: jax.Array,
    a_idx: jax.Array, b_idx: jax.Array, c_seg: jax.Array,
    c_hi: jax.Array, c_lo: jax.Array, c_offsets: jax.Array,
    num_c_blocks: int, num_c_nnz: int,
):
    """Chunked-XLA numeric + bitmap compress — the ONLY numeric variant of
    the fully-padded path (the task-SELL/pallas layouts need host-side
    group statics, which a jit-traced static-bound path cannot build; use
    spgemm()/prepare_product()/prepare_sharded_product for those)."""
    c_dense = _numeric_xla(
        a_flat, b_flat, a_idx, b_idx, c_seg, num_c_blocks
    )

    # Compress through C's structural bitmap (row-major / untransposed):
    # value slot of address a is offsets + prefix-popcount (the inverse of
    # decompress_blocks).
    bits = bm.expand_bits(c_hi[:num_c_blocks], c_lo[:num_c_blocks])
    slot = bm.prefix_popcount(bits)
    pos = jnp.where(
        bits > 0,
        c_offsets[:num_c_blocks, None] + slot,
        num_c_nnz,  # out of range -> dropped
    )
    c_values = jnp.zeros((num_c_nnz,), c_dense.dtype).at[pos.reshape(-1)].set(
        c_dense.reshape(-1), mode="drop"
    )
    return c_values


# ---------------------------------------------------------------------------
# Shared orchestration: symbolic phases + device numeric plan
# ---------------------------------------------------------------------------
class _ProductPlan:
    """Everything structure-dependent about one C = A @ B product:
    symbolic results (keys_tbl), the device numeric plan (sigma tables +
    K-groups + gather windows + compress tables), and the assembled
    container metadata. Value-independent — ops.product.PreparedProduct
    caches one of these per structure."""

    __slots__ = (
        "a", "b", "a_flat", "b_flat", "keys_tbl",
        "starts_sig", "cnt_sig", "ends_sig", "groups",
        "tas", "tbs", "sig_st", "sig_sigma",
        "win", "win_starts", "jmax", "g_tbl", "compress_mode",
        "num_tasks", "num_alive", "num_c_blocks", "num_c_nnz",
        "nbc_pad", "nb_pad_c", "nnz_pad", "a_idx", "b_idx", "c_seg",
        "cbrow", "cbcol", "c_off", "c_hi", "c_lo",
    )


@partial(jax.jit, static_argnames=("t_pad", "sentinel", "nbc_pad"))
def _plan_fused(a, b, offs, b_row_start, total,
                t_pad: int, sentinel: int, nbc_pad: int):
    """T3..T9 as ONE jitted program: task build + sort, the two-level
    symbolic scan, the device numeric plan, the window-stat chunk
    permutation, and the compress-run stats — ending in a single packed
    int32 packet so the host needs exactly one fetch for every
    data-dependent static. Together with the T1 task-total fetch this is
    the two-D->H-sync discipline of the reference
    (ref: src/bmSparse_SPGEMM.cu:1095,1106)."""
    a_idx, b_idx, ck_row, ck_col, t_ph, t_pl, nz_total = _build_tasks(
        a, b, offs, b_row_start, total, t_pad, sentinel
    )
    c_seg, keys_tbl, nbc, nnzc = _c_symbolic_scan(
        t_ph, t_pl, ck_row, ck_col, sentinel, a_idx, b_idx
    )
    (starts_sig, ends_sig, cnt_sig, nat_of_sig, k_chunk, chunk_stats,
     nat_cols, sig_cols) = _plan_sell_device(
        c_seg, nz_total, nbc, nbc_pad, keys_tbl)
    # compress-run stats: contributors to each 64-wide output row form a
    # contiguous run in natural order; jmax = the longest run
    b_iota = jnp.arange(nbc_pad, dtype=jnp.int32)
    validb = b_iota < nbc
    b_row = jnp.where(validb, nat_cols[4] // 64, jnp.int32(2**30))
    newr = jnp.concatenate(
        [jnp.ones((1,), bool), b_row[1:] != b_row[:-1]])
    run_start = jax.lax.cummax(jnp.where(newr, b_iota, 0))
    jmax = jnp.max(jnp.where(validb, b_iota - run_start, 0)) + 1
    head = jnp.stack(
        [nz_total, nbc, nnzc, jmax]).astype(jnp.int32)
    packet = jnp.concatenate([head, k_chunk, *chunk_stats])
    return (packet, keys_tbl, c_seg, a_idx, b_idx,
            starts_sig, cnt_sig, ends_sig, nat_cols, nat_of_sig,
            sig_cols)


# windowed-gather policy (rows = dense 64-slot tiles, 256 B each f32):
_WIN_TABLE_MIN_ROWS = 1 << 17   # window only when the table exceeds 32 MB
_WIN_MAX_ROWS = 1 << 18         # give up past 64 MB windows (span too wide)
_FOLD_MAX_J = 16                # gather-fold compress only for short runs
_FOLD_MAX_ROWS = 196608         # fold only while the w table stays small


def _plan_windows(groups, amin_c, amax_c, bmin_c, bmax_c,
                  nb_a: int, nb_b: int):
    """Per-group, per-slab gather windows from the per-chunk operand
    spans (host side, numpy; all inputs came in the plan packet).

    Chunks were permuted by min A index inside each K-group, so slab
    spans are tight for locality-bearing structures; a side whose table
    is small, or whose spans stay wide (no locality to exploit), keeps
    the full-table gather (wa/wb = 0)."""
    import numpy as np

    from ..config import round_up

    win = []
    win_starts = []
    for kg, c0, c1 in groups:
        ch = c1 - c0
        ch_pad = bucket_size(ch, minimum=1)
        slab = _slab_chunks(ch_pad, kg)
        nsl = -(-ch_pad // slab)
        sa = np.zeros((nsl,), np.int32)
        sb = np.zeros((nsl,), np.int32)
        span_a = 1
        span_b = 1
        for s in range(nsl):
            lo_c = c0 + s * slab
            hi_c = min(c0 + (s + 1) * slab, c1)
            if lo_c >= c1:
                continue
            a0 = int(amin_c[lo_c:hi_c].min())
            a1 = int(amax_c[lo_c:hi_c].max())
            b0 = int(bmin_c[lo_c:hi_c].min())
            b1 = int(bmax_c[lo_c:hi_c].max())
            if a1 >= a0:
                sa[s] = a0
                span_a = max(span_a, a1 - a0 + 1)
            if b1 >= b0:
                sb[s] = b0
                span_b = max(span_b, b1 - b0 + 1)
        wa = wb = 0
        if nb_a + 1 > _WIN_TABLE_MIN_ROWS:
            w = bucket_size(round_up(span_a, 512), minimum=512)
            if w <= min(_WIN_MAX_ROWS, (nb_a + 1) // 2):
                wa = int(w)
                sa = np.clip(sa, 0, max(nb_a + 1 - wa, 0))
        if nb_b + 1 > _WIN_TABLE_MIN_ROWS:
            w = bucket_size(round_up(span_b, 512), minimum=512)
            if w <= min(_WIN_MAX_ROWS, (nb_b + 1) // 2):
                wb = int(w)
                sb = np.clip(sb, 0, max(nb_b + 1 - wb, 0))
        win.append((wa, wb))
        win_starts.append((jnp.asarray(sa), jnp.asarray(sb)))
    return tuple(win), tuple(win_starts)


def _plan_product(a, b, a_prep, b_prep, timer, verbose) -> _ProductPlan:
    """Run T1-T9 with exactly TWO host syncs — the task total (fixes the
    static task shape) and the packed plan packet — matching the
    reference's two scalar D->H memcpys per multiply
    (ref: src/bmSparse_SPGEMM.cu:1095,1106). Everything else is one fused
    device program (_plan_fused) plus host-side static planning on the
    packet."""
    import numpy as np

    from ..config import round_up

    p = _ProductPlan()
    p.a, p.b = a, b
    nbr_b = b.block_rows
    with timer.phase("T_1"):
        cnt, offs, b_row_start, total = _task_counts(a, b, nbr_b)
        p.num_tasks = int(total)  # host sync 1 of 2 (ref analogue :1095)
    sentinel = a.block_rows + 1

    t_pad = round_up(bucket_size(max(p.num_tasks, 1)), _SCAN_W)
    p.nbc_pad = round_up(t_pad, 128)

    # Decompress once (async dispatch; amortized if operands came in
    # Prepared).
    p.a_flat = (a_prep.dense_flat if a_prep is not None
                else a.decompress_blocks_flat())
    p.b_flat = (b_prep.dense_flat if b_prep is not None
                else b.decompress_blocks_flat())

    with timer.phase("T_3"):
        (packet, keys_tbl, c_seg, a_idx, b_idx,
         starts_sig, cnt_sig, ends_sig, nat_cols, nat_of_sig,
         sig_cols) = _plan_fused(
            a, b, offs, b_row_start, total, t_pad, sentinel, p.nbc_pad)
    with timer.phase("T_6"):
        pkt = np.asarray(packet)  # host sync 2 of 2 (ref :1106)
    nchunk = p.nbc_pad // 128
    p.num_alive = int(pkt[0])
    p.num_c_blocks = int(pkt[1])
    p.num_c_nnz = int(pkt[2])
    p.jmax = int(pkt[3])
    kc = pkt[4:4 + nchunk]
    amin_c = pkt[4 + nchunk:4 + 2 * nchunk]
    amax_c = pkt[4 + 2 * nchunk:4 + 3 * nchunk]
    bmin_c = pkt[4 + 3 * nchunk:4 + 4 * nchunk]
    bmax_c = pkt[4 + 4 * nchunk:4 + 5 * nchunk]
    if verbose:
        print(f"Task list size: {p.num_tasks}")
        print(f"Bmp reduction: {p.num_tasks - p.num_alive}")

    p.a_idx, p.b_idx, p.c_seg, p.keys_tbl = a_idx, b_idx, c_seg, keys_tbl
    p.starts_sig, p.cnt_sig, p.ends_sig = starts_sig, cnt_sig, ends_sig
    p.sig_sigma = sig_cols
    p.nnz_pad = max(bucket_size(max(p.num_c_nnz, 1)), 1)

    with timer.phase("T_9"):
        p.groups = _contiguous_k_groups(kc)
        p.win, p.win_starts = _plan_windows(
            p.groups, amin_c, amax_c, bmin_c, bmax_c,
            p.a_flat.shape[0], p.b_flat.shape[0])
        # compress plan: gather-fold when contributor runs are short and
        # padding stays bounded, else the row scatter-add. The fold's
        # gathers read the (R, 128) packed-row table, so large products
        # keep the scatter.
        r_rows = sum(
            bucket_size(c1 - c0, minimum=1) * 128
            for _, c0, c1 in p.groups
        )
        t_rows_pad = max(-(-p.nnz_pad // 64), 1)
        # fold is opt-in (config "fold"); auto keeps the scatter
        use_fold = (
            get_config().spgemm_compress == "fold"
            and p.groups and 0 < p.jmax <= _FOLD_MAX_J
            and t_rows_pad * p.jmax <= max(4 * r_rows, 1)
            and r_rows <= _FOLD_MAX_ROWS
        )
        chunk_base = np.full((nchunk,), r_rows, np.int64)
        base = 0
        for kg, c0, c1 in p.groups:
            ch_pad = bucket_size(c1 - c0, minimum=1)
            chunk_base[c0:c1] = base + (
                np.arange(c1 - c0, dtype=np.int64) * 128)
            base += ch_pad * 128
        p.compress_mode = "fold" if use_fold else "scatter"
        p.nb_pad_c = min(
            round_up(max(bucket_size(max(p.num_c_blocks, 1)), 128), 128),
            p.nbc_pad,
        )
        # plan stage 2 as ONE jitted dispatch (slot tables, stacked
        # compress columns, fold table, container fields) instead of a
        # dozen small ones in one-shot spgemm()
        (p.tas, p.tbs, p.sig_st, p.g_tbl,
         p.cbrow, p.cbcol, c_hi, c_lo, p.c_off) = _plan_stage2(
            keys_tbl, starts_sig, cnt_sig, sig_cols, nat_cols,
            nat_of_sig, jnp.asarray(chunk_base, jnp.int32),
            jnp.int32(p.num_c_blocks), jnp.int32(p.num_c_nnz),
            groups=tuple(p.groups),
            sent_a=p.a_flat.shape[0], sent_b=p.b_flat.shape[0],
            j_max=(p.jmax if use_fold else 0),
            t_rows_pad=t_rows_pad, nb_pad_c=p.nb_pad_c,
            block_rows_a=a.block_rows,
        )
        p.c_hi = c_hi.astype(jnp.uint32)
        p.c_lo = c_lo.astype(jnp.uint32)
    return p


@partial(jax.jit, static_argnames=(
    "groups", "sent_a", "sent_b", "j_max", "t_rows_pad", "nb_pad_c",
    "block_rows_a"))
def _plan_stage2(
    keys_tbl, starts_sig, cnt_sig, sig_cols, nat_cols, nat_of_sig,
    chunk_base, nbc, nnzc,
    groups: tuple, sent_a: int, sent_b: int, j_max: int,
    t_rows_pad: int, nb_pad_c: int, block_rows_a: int,
):
    """Everything the plan derives AFTER the packet, in one dispatch:
    per-group slot operand tables, stacked sigma compress columns, the
    fold contributor table (j_max = 0 means scatter mode — a dummy is
    returned), and the masked natural-order container fields."""
    nbc_pad = starts_sig.shape[0]
    tas = []
    tbs = []
    sig_st = [[], [], []]
    for g, (kg, c0, c1) in enumerate(groups):
        ch = c1 - c0
        ch_pad = bucket_size(ch, minimum=1)
        ta, tb = _gather_group_slots(
            keys_tbl, starts_sig, cnt_sig,
            jnp.int32(c0), ch_pad, kg, sent_a, sent_b,
        )
        tas.append(ta)
        tbs.append(tb)
        lo_r = c0 * 128
        real = min(ch * 128, max(nbc_pad - lo_r, 0))
        for i in range(3):
            seg = jax.lax.slice(sig_cols[i], (lo_r,), (lo_r + real,))
            if real < ch_pad * 128:
                seg = jnp.concatenate([
                    seg, jnp.zeros((ch_pad * 128 - real,), jnp.int32)])
            sig_st[i].append(seg)
    sig_st_t = tuple(
        (c[0] if len(c) == 1 else jnp.concatenate(c))
        if c else jnp.zeros((1,), jnp.int32)
        for c in sig_st
    )
    if j_max > 0:
        g_tbl = _compress_fold_plan(
            nat_cols[4], nat_of_sig, chunk_base, nbc,
            j_max=j_max, t_rows_pad=t_rows_pad)
    else:
        g_tbl = jnp.zeros((1, 1), jnp.int32)
    b_iota = jnp.arange(nb_pad_c, dtype=jnp.int32)
    valid_b = b_iota < nbc
    cbrow = jnp.where(valid_b, nat_cols[0][:nb_pad_c],
                      jnp.int32(block_rows_a))
    cbcol = jnp.where(valid_b, nat_cols[1][:nb_pad_c], 0)
    c_hi = jnp.where(valid_b, nat_cols[2][:nb_pad_c], 0)
    c_lo = jnp.where(valid_b, nat_cols[3][:nb_pad_c], 0)
    c_off = jnp.where(
        valid_b, nat_cols[4][:nb_pad_c],
        jnp.maximum(nnzc - 1, 0).astype(jnp.int32))
    return (tuple(tas), tuple(tbs), sig_st_t, g_tbl,
            cbrow, cbcol, c_hi, c_lo, c_off)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def resolve_impl(impl: str | None) -> str:
    """The numeric kernel an impl request runs: None -> the configured
    default; "auto" -> the fused Triton kernel on a GPU (it measured
    faster than "sell" there, PERF.md), the XLA task-SELL form elsewhere."""
    impl = impl or get_config().spgemm_impl
    if impl not in ("xla", "sell", "pallas", "auto"):
        raise ValueError(f"unknown SpGEMM impl {impl!r}")
    if impl == "auto":
        return "pallas" if jax.default_backend() == "gpu" else "sell"
    return impl


def spgemm(
    a,
    b,
    impl: str | None = None,
    verbose: bool | None = None,
) -> BmSparse:
    """C = A @ B, host-orchestrated (dynamic exact-ish shapes).

    Mirrors the reference driver defaults: A untransposed, B in transposed
    intra-block layout (ref: src/bmSparse_SPGEMM.cu:1261-1262), fp32 output.
    Operands may be BmSparse or Prepared (ops.plan.prepare) — pass Prepared
    when reusing a matrix across calls to amortize decompression. For
    iterated products with fixed structure use ops.product.prepare_product.

    impl selects the numeric kernel (the analogue of the reference's
    tc_version switch, ref :1132-1155; every variant computes identical
    results):
      * "auto" (default) — "pallas" on a GPU, "sell" elsewhere.
      * "sell" — task-SELL slot layout, XLA-fused FMAs.
      * "pallas" — task-SELL with the fused Triton kernel
        (ops/pallas/spgemm_kernel.py) for the product+reduce stage; GPU
        only (raises on any other backend).
      * "xla" — chunked gather + segment-sum (the jit-safe formulation the
        shard_map path uses; slower, kept honest and selectable).
    """
    from .plan import Prepared, as_matrix

    a_prep = a if isinstance(a, Prepared) else None
    b_prep = b if isinstance(b, Prepared) else None
    a, b = as_matrix(a), as_matrix(b)
    _check_operands(a, b)
    cfg = get_config()
    impl = resolve_impl(impl)
    verbose = cfg.verbose if verbose is None else verbose
    timer = PhaseTimer(enabled=verbose)

    p = _plan_product(a, b, a_prep, b_prep, timer, verbose)

    with timer.phase("T_9b"):
        c_values = _numeric_from_plan(p, impl)
    timer.report()

    return _assemble_c(p, c_values)


@partial(
    jax.jit,
    static_argnames=("groups", "impl", "nnz_pad", "win", "compress"),
)
def _numeric_stage(
    a_flat, b_flat, tas, tbs, sig_hi, sig_lo, sig_off,
    win_starts, g_tbl,
    groups: tuple, impl: str, nnz_pad: int,
    win: tuple = (), compress: str = "scatter",
):
    """The ENTIRE numeric phase (operand gathers, products, K-sums,
    compress) as one jitted program — one dispatch per multiply.

    Everything structural is PLAN data: tas/tbs are the per-group slot
    operand tables, sig_hi/lo/off the stacked-row compress columns,
    win/win_starts the per-group gather windows, g_tbl the fold-compress
    contributor table ("fold") vs the row scatter-add ("scatter")."""
    c_rows = _numeric_sell_parts(
        a_flat, b_flat, tas, tbs, list(groups), impl, win, win_starts)
    hi = sig_hi.astype(jnp.uint32)
    lo = sig_lo.astype(jnp.uint32)
    if compress == "fold":
        return _compress_fold(c_rows, hi, lo, sig_off, g_tbl, nnz_pad)
    return _compress_rows(c_rows, hi, lo, sig_off, nnz_pad)


def _numeric_from_plan(p: _ProductPlan, impl: str,
                       a_flat=None, b_flat=None) -> jax.Array:
    """Numeric phase + bit-order compress, given a structure plan.
    a_flat/b_flat override the plan's operand tiles (same structure,
    new values — ops.product.PreparedProduct)."""
    a_flat = p.a_flat if a_flat is None else a_flat
    b_flat = p.b_flat if b_flat is None else b_flat
    if impl == "xla":
        if p.num_alive == 0:
            return jnp.zeros(
                (p.nnz_pad,),
                jnp.promote_types(a_flat.dtype, jnp.float32))
        # chunked segment-sum numeric (the jit-safe variant the
        # shard_map path uses)
        return _numeric_and_compress(
            a_flat, b_flat,
            p.a_idx[: p.num_alive], p.b_idx[: p.num_alive],
            p.c_seg[: p.num_alive],
            p.c_hi, p.c_lo, p.c_off,
            p.nb_pad_c, p.nnz_pad,
        )
    if p.groups and p.num_c_blocks > 0:
        return _numeric_stage(
            a_flat, b_flat, p.tas, p.tbs,
            p.sig_st[0], p.sig_st[1], p.sig_st[2],
            p.win_starts, p.g_tbl,
            tuple(p.groups), impl, p.nnz_pad,
            win=p.win, compress=p.compress_mode,
        )
    return jnp.zeros(
        (p.nnz_pad,), jnp.promote_types(a_flat.dtype, jnp.float32))


def _assemble_c(p: _ProductPlan, c_values: jax.Array) -> BmSparse:
    return BmSparse(
        brow=p.cbrow, bcol=p.cbcol,
        bmp_hi=p.c_hi, bmp_lo=p.c_lo,
        offsets=p.c_off, values=c_values,
        nb=jnp.int32(p.num_c_blocks),
        num_rows=p.a.num_rows, num_cols=p.b.num_cols, nnz=p.num_c_nnz,
        transposed=False,
    )


@partial(
    jax.jit,
    static_argnames=("max_tasks", "max_c_blocks", "max_c_nnz"),
)
def spgemm_padded(
    a: BmSparse,
    b: BmSparse,
    max_tasks: int,
    max_c_blocks: int | None = None,
    max_c_nnz: int | None = None,
) -> BmSparse:
    """Fully jit-compatible C = A @ B with static upper bounds.

    The result is padded: `C.nb` is the true block count; blocks past it
    have zero bitmaps. Used by the shard_map multi-chip path, where shapes
    must be static per shard. Always runs the chunked-XLA numeric (see
    _numeric_and_compress); the sell/pallas layouts require host-side
    planning and are reached via spgemm() / prepare_product() /
    prepare_sharded_product() instead.
    """
    max_c_blocks = max_c_blocks or max_tasks
    max_c_nnz = max_c_nnz or max_c_blocks * 64
    nbr_b = b.block_rows
    sentinel = a.block_rows + 1

    cnt, offs, b_row_start, total = _task_counts(a, b, nbr_b)
    a_idx, b_idx, ck_row, ck_col, t_ph, t_pl, _ = _build_tasks(
        a, b, offs, b_row_start, total, max_tasks, sentinel
    )
    c_seg, cbrow, cbcol, c_hi, c_lo, c_off, nbc, nnzc = _c_symbolic(
        t_ph, t_pl, ck_row, ck_col, sentinel
    )
    k = min(max_c_blocks, max_tasks)
    c_values = _numeric_and_compress(
        a.decompress_blocks_flat(), b.decompress_blocks_flat(),
        a_idx, b_idx, c_seg,
        c_hi[:k], c_lo[:k], c_off[:k],
        k, max_c_nnz,
    )
    return BmSparse(
        brow=cbrow[:k], bcol=cbcol[:k],
        bmp_hi=c_hi[:k], bmp_lo=c_lo[:k],
        offsets=c_off[:k], values=c_values,
        nb=nbc,
        num_rows=a.num_rows, num_cols=b.num_cols, nnz=max_c_nnz,
        transposed=False,
    )
