"""Execution plans: per-matrix preparation for the tiered SpMV.

The reference decompresses blocks inside every kernel launch via
prefix-popcount shared-memory staging (ref: src/bmSparse_SPGEMM.cu:152-162)
and reduces per-row partials with warp shuffles
(ref: src/bmSparse_SPMV.cu:172-187). Here all data-dependent addressing
moves into a one-time host-side `prepare()` step, and the per-call op is
reshaped so that the only remaining dynamic access is one bounded gather
of v:

Tier 1 — DIA (scalar diagonals): diagonals whose fill fraction exceeds
  `DIA_MIN_FILL` are extracted into a dense (ndiags, n) strip. Their SpMV
  contribution is ndiags shifted fused multiply-adds over the rows: no
  gathers, no scatters, one streaming pass. Chosen because
  SuiteSparse/PDE matrices are diagonally clustered.

Tier 2 — SELL (sliced-ELL over 8x8 blocks, C = 128 rows per chunk):
  remaining blocks are organized with the *block-row index on the
  128-wide axis*. Block rows are sorted by block count (SELL-sigma),
  grouped into chunks of 128 rows, and each chunk padded to its
  (bucketed) max count K. The per-row reduction becomes a dense sum over
  the K axis — segment_sum is eliminated. The only dynamic access left is
  the gather of v block segments (one take per K-group) and the final
  inverse-permutation row gather.

Stream tier (ops/route.py): scattered structures with about one nonzero
  per block (webgraphs, uniform random) route their scalars through a
  static routing network instead of reading a mostly-zero slab per slot;
  prepare() picks it by a cost model with constants measured on the GPU.

A Prepared object is a pytree and feeds jitted ops and shard_map directly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BLOCK_HEIGHT
from ..format.bmsparse import BmSparse, cdiv

# Bump whenever prepare()'s output layout/semantics change — disk-cached
# plan dumps (io/binary.save_prepared) are stamped with this and refuse
# to load across layout changes.
PLAN_LAYOUT_VERSION = 11

SELL_C = 128                 # block rows per SELL chunk
DIA_MIN_FILL = 0.15          # min diagonal fill to justify a dense pass
MAX_DIAGS = 128              # cap on extracted diagonals
_K_BUCKETS = tuple(
    sorted({1, 2, 3} | {m for b in range(2, 16) for m in ((1 << b), 3 << (b - 1))})
)


def _bucket_k(k: int) -> int:
    for b in _K_BUCKETS:
        if b >= k:
            return b
    return k


MAX_SELL_GROUPS = 12     # cap on adaptive per-matrix K classes


def _adaptive_k_buckets(chunk_max: "np.ndarray") -> "np.ndarray":
    """Per-chunk padded depths from an OPTIMAL bucket set fitted to this
    matrix's chunk-max histogram (<= MAX_SELL_GROUPS distinct values).

    The fixed geometric _K_BUCKETS ladder pads power-law degree
    structures badly (sigma already makes chunks homogeneous, so the
    ladder is the whole padding overhead, and slot count is the SpMV
    gather count). A small
    partition DP over the <=few-hundred distinct maxima picks the
    padded-slot-minimizing bucket values exactly; matrices with few
    distinct depths (banded/stencil/blockdense) get their exact values
    back, so only skewed structures change. Used for single-chip plans;
    the sharded path keeps the fixed ladder so per-shard K classes stay
    unifiable across shards."""
    uniq, inv, wts = np.unique(
        chunk_max, return_inverse=True, return_counts=True)
    m_u = len(uniq)
    if m_u <= MAX_SELL_GROUPS:
        return chunk_max.copy()
    if m_u > 512:
        # bound the DP to its intended cost: pre-quantize the histogram
        # to the geometric ladder (<= ~40 rungs), then pick classes
        # among rungs; the ladder-total guard below keeps the result
        # no worse than the plain ladder
        ladder_u = np.array([_bucket_k(int(v)) for v in uniq], np.int64)
        uniq2, inv2 = np.unique(ladder_u, return_inverse=True)
        wts = np.bincount(inv2, weights=wts).astype(np.int64)
        inv = inv2[inv]
        uniq = uniq2
        m_u = len(uniq)
    # weighted suffix-partition DP: cost(i..j) = uniq[j] * sum(w[i..j])
    G = MAX_SELL_GROUPS
    wcum = np.concatenate([[0], np.cumsum(wts)])
    INF = float("inf")
    f = np.full((m_u + 1, G + 1), INF)
    arg = np.zeros((m_u + 1, G + 1), np.int64)
    f[0, 0] = 0.0
    for j in range(1, m_u + 1):
        for g in range(1, min(G, j) + 1):
            # last bucket covers uniq[i..j-1], padded to uniq[j-1]
            costs = f[:j, g - 1] + int(uniq[j - 1]) * (
                wcum[j] - wcum[:j])
            i_best = int(np.argmin(costs))
            f[j, g] = costs[i_best]
            arg[j, g] = i_best
    g_best = int(np.argmin(f[m_u, 1:])) + 1
    cuts = []
    j = m_u
    g = g_best
    while j > 0:
        cuts.append(j - 1)              # bucket value index uniq[j-1]
        j = int(arg[j, g])
        g -= 1
    bucket_vals = uniq[np.array(sorted(cuts))]
    pad_to = bucket_vals[np.searchsorted(bucket_vals, uniq)]
    dp_pad = pad_to[inv]
    # never worse than the fixed ladder: with the class budget binding
    # (depths spanning more rungs than MAX_SELL_GROUPS), merged classes
    # can pad more than the ladder's <=1.5x steps — keep the better one
    ladder_pad = np.array(
        [_bucket_k(int(k)) for k in chunk_max], np.int64)
    if dp_pad.sum() > ladder_pad.sum():
        return ladder_pad
    return dp_pad


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Prepared:
    """A BmSparse plus its tiered execution plan."""

    m: BmSparse
    # (nb_pad, 64) row-major dense slots — LAZY (see the dense_flat
    # property): only the SpGEMM paths consume it, so SpMV plans never
    # materialise it
    dense_flat_: jax.Array | None = None
    plan_dtype: str = dataclasses.field(
        metadata=dict(static=True), default="float32")

    # --- DIA tier (None disables) ---
    # natural (rows, 128) layout: dia[d, q, l] is the diagonal-d entry of
    # scalar row q*128 + l, so the flat<->2-D reshapes are free.
    dia: jax.Array | None = None          # (nd, ceil(npad/128), 128) f32
    dia_offsets: tuple = dataclasses.field(
        metadata=dict(static=True), default=())

    # --- SELL tier: groups of 128-row chunks sharing padded depth K ---
    # sell_dense[g]: (8, chunks_g, K_g, 8, 128) f32, [j, chunk, k, i, lane]
    #   (j-major so the product loop lines up with the gathered v segments
    #   without any runtime transpose)
    # sell_bcol[g]: (chunks_g * K_g * 128,) int32 flat, padding ->
    #   block_cols
    sell_dense: tuple = ()
    sell_bcol: tuple = ()
    sell_ks: tuple = dataclasses.field(metadata=dict(static=True), default=())
    # Row map: block-row r's SELL output lives at stacked row out_gather[r];
    # rows with no SELL blocks point past the end (taken with fill=0).
    out_gather: jax.Array | None = None   # (block_rows,) int32
    sell_rows: int = dataclasses.field(metadata=dict(static=True), default=0)

    # --- Stream tier: scattered-structure path (ops/route.py) ---
    # None unless prepare()'s cost model routes the structure here.
    stream: "object | None" = None

    @property
    def dense_flat(self) -> jax.Array:
        """(nb_pad, 64) dense row-major slots in the plan dtype, computed
        on first SpGEMM use and memoized (not under a trace)."""
        df = object.__getattribute__(self, "dense_flat_")
        if df is not None:
            return df
        m = object.__getattribute__(self, "m")
        df = m.decompress_blocks_flat().astype(jnp.dtype(self.plan_dtype))
        if not isinstance(df, jax.core.Tracer):
            object.__setattr__(self, "dense_flat_", df)
        return df

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "m"), name)


def _build_sell_tier(
    ub_idx: np.ndarray,
    ubr: np.ndarray, ubc: np.ndarray,
    slot: np.ndarray, vals: np.ndarray, binv: np.ndarray,
    nbr: int, ncu: int, cw: int, np_dtype,
    *,
    forced_groups=None,
    adaptive: bool = False,
    secondary_wlo: bool = False,
):
    """Build one SELL tier over the super-slots selected by ub_idx
    (sorted global indices into the ublocks arrays).

    Returns (dense, bcol, ks, out_gather_np, rows_total).
    """
    sel_ubr = ubr[ub_idx]
    sel_ubc = ubc[ub_idx]
    row_count = np.bincount(sel_ubr, minlength=nbr)
    nonempty = np.nonzero(row_count)[0]
    # SELL-sigma row order; see prepare() for the tie-break rationale
    if secondary_wlo:
        row_minbc = np.full((nbr,), np.int64(ncu))
        np.minimum.at(row_minbc, sel_ubr, sel_ubc)
        perm = nonempty[np.lexsort(
            (nonempty, row_minbc[nonempty], -row_count[nonempty])
        )]
    else:
        perm = nonempty[np.argsort(-row_count[nonempty], kind="stable")]
    row_pos = np.full((nbr,), -1, np.int64)
    row_pos[perm] = np.arange(len(perm))

    nchunks = cdiv(len(perm), SELL_C)
    counts_sorted = row_count[perm]
    cs_pad = np.zeros((nchunks * SELL_C,), np.int64)
    cs_pad[: len(perm)] = counts_sorted
    cm = cs_pad.reshape(nchunks, SELL_C).max(axis=1) if nchunks else \
        np.zeros((0,), np.int64)
    if forced_groups is None and adaptive:
        k_chunk = _adaptive_k_buckets(cm)
    else:
        k_chunk = np.array([_bucket_k(int(k)) for k in cm], np.int64)

    p = row_pos[sel_ubr]
    chunk = p // SELL_C
    lane = p % SELL_C
    # rank of the slot within its row (sel arrays are sorted by
    # (row, col) because ub_idx is ascending over sorted ublocks)
    krank = np.arange(len(sel_ubr)) - np.searchsorted(sel_ubr, sel_ubr)

    if forced_groups is not None:
        # (K, capacity) pairs; this matrix's chunks with depth K fill
        # the K group in chunk order, the rest is padding
        groups_spec = list(forced_groups)
        kvals = [k for k, _ in groups_spec]
        assert all(int(k) in kvals for k in np.unique(k_chunk)), (
            "forced layout lacks a K group this shard needs"
        )
        group_of_chunk = np.array(
            [kvals.index(int(k)) for k in k_chunk], np.int64
        )
        local_of_chunk = np.zeros((nchunks,), np.int64)
        seen: dict = {}
        for c in range(nchunks):
            g = int(group_of_chunk[c])
            local_of_chunk[c] = seen.get(g, 0)
            seen[g] = local_of_chunk[c] + 1
        for g, (k, cap) in enumerate(groups_spec):
            assert seen.get(g, 0) <= cap
        groups = [(int(k), int(cap)) for k, cap in groups_spec]
    else:
        # groups keyed K desc; chunks keep their stable order within a
        # group
        uniq = sorted({int(k) for k in k_chunk}, reverse=True)
        gid_of = {kk: i for i, kk in enumerate(uniq)}
        group_of_chunk = np.array(
            [gid_of[int(kk)] for kk in k_chunk], np.int64
        ) if nchunks else np.zeros((0,), np.int64)
        local_of_chunk = np.zeros((nchunks,), np.int64)
        caps = np.zeros((max(len(uniq), 1),), np.int64)
        for g in range(len(uniq)):
            sel_c = np.nonzero(group_of_chunk == g)[0]
            local_of_chunk[sel_c] = np.arange(len(sel_c))
            caps[g] = len(sel_c)
        groups = [(uniq[g], int(caps[g])) for g in range(len(uniq))]

    bases = np.cumsum([0] + [cap * SELL_C for _, cap in groups])
    dense_l: list = []
    bcol_l: list = []
    ks_l: list = []
    for g, (kg, cap) in enumerate(groups):
        sel = group_of_chunk[chunk] == g if nchunks else np.zeros((0,), bool)
        ub_sel = np.nonzero(sel)[0]
        dense_g = np.zeros((cap, kg, cw * 8, SELL_C), np_dtype)
        bcol_g = np.full((cap, kg, SELL_C), ncu, np.int32)
        if len(ub_sel):
            cl = local_of_chunk[chunk[ub_sel]]
            kk = krank[ub_sel]
            ll = lane[ub_sel]
            bcol_g[cl, kk, ll] = sel_ubc[ub_sel]
            # scatter scalars of the selected slots
            sel_all = np.zeros((len(ubr),), bool)
            sel_all[ub_idx[ub_sel]] = True
            s_sel = sel_all[binv]
            loc = np.searchsorted(ub_idx[ub_sel], binv[s_sel])
            dense_g[cl[loc], kk[loc], slot[s_sel], ll[loc]] = vals[s_sel]
        dense_l.append(jnp.asarray(np.ascontiguousarray(
            dense_g.reshape(cap, kg, cw, 8, SELL_C)
            .transpose(2, 0, 1, 3, 4)
        )))
        bcol_l.append(jnp.asarray(bcol_g.reshape(-1)))
        ks_l.append(kg)

    rows_total = int(bases[-1])
    if nchunks:
        stacked_pos = (
            bases[group_of_chunk] + local_of_chunk * SELL_C
        )                                   # per chunk
        og = np.where(
            row_pos >= 0,
            stacked_pos[np.clip(row_pos // SELL_C, 0, nchunks - 1)]
            + row_pos % SELL_C,
            rows_total,
        ).astype(np.int32)
    else:
        og = np.full((nbr,), rows_total, np.int32)
    return dense_l, bcol_l, ks_l, og, rows_total


def _choose_diagonals(
    rows: np.ndarray, cols: np.ndarray, n_rows: int, n_cols: int,
    col_shift: int = 0,
) -> np.ndarray:
    """Offsets of diagonals dense enough for the DIA tier."""
    if len(rows) == 0:
        return np.empty((0,), np.int64)
    dev = cols.astype(np.int64) - rows.astype(np.int64) - col_shift
    # offset histogram via bincount over the bounded range (np.unique
    # sorts the whole nnz stream — ~4 s at 35M nnz, bincount ~0.1 s)
    lo_b = int(dev.min())
    hist = np.bincount(dev - lo_b)
    offs = np.nonzero(hist)[0] + lo_b
    counts = hist[offs - lo_b]
    # diag o holds (i, i+col_shift+o) for
    # i in [max(0,-col_shift-o), min(n_rows, n_cols-col_shift-o))
    length = (np.minimum(n_rows, n_cols - col_shift - offs)
              - np.maximum(0, -col_shift - offs))
    fill = counts / np.maximum(length, 1)
    keep = offs[fill >= DIA_MIN_FILL]
    if len(keep) > MAX_DIAGS:
        order = np.argsort(fill[np.isin(offs, keep)])[::-1]
        keep = keep[order[:MAX_DIAGS]]
    return np.sort(keep)


def _use_superslots(nblk: int, nwin: int, itemsize: int) -> bool:
    """cw = 64 super-slots when merging a row's blocks into 64-column
    windows at least halves the slot count (and the slabs stay < 2 GB)."""
    return nblk >= 2 * nwin and nwin * 512 * itemsize <= (2 << 30)


def _block_cost_estimate(nblk: int, nwin: int, itemsize: int) -> float:
    """Per-SpMV seconds of the block SELL tiers: a slot reads its
    cw*8-scalar slab and gathers cw values of v (ops/route.py constants)."""
    from .route import BLOCK_BW, GATHER_NS

    if _use_superslots(nblk, nwin, itemsize):
        return nwin * (512 * itemsize / BLOCK_BW + 64 * GATHER_NS)
    return nblk * (64 * itemsize / BLOCK_BW + 8 * GATHER_NS)


def _route_stream(rows, cols, vals, nblk: int, nwin: int,
                  n_rows: int, n_cols: int, np_dtype, force: bool):
    """Stream-tier routing decision and plan (ops/route.py).

    A block SELL slot reads a cw*8-scalar dense slab and gathers cw
    values of v; the stream tier routes individual scalars. Rows heavier
    than K_CAP stay on the SELL machinery (deep rows amortise its
    gathers). Returns (plan, keep) with keep masking the scalars left for
    the block tiers, or (None, None) when the block tiers win."""
    from .route import (
        K_CAP, RES_NS, build_stream_plan, stream_cost_estimate,
    )

    est_block = _block_cost_estimate(nblk, nwin, np_dtype.itemsize)
    rcount = np.bincount(rows, minlength=n_rows)
    # k of the stream grid = deepest row BELOW the cap (heavier rows
    # route to the SELL machinery)
    under = rcount[rcount <= K_CAP]
    k_est = int(under.max()) if len(under) else 1
    est_stream = stream_cost_estimate(len(rows), k_est, n_rows)
    # 2x margin: only reroute when the model says the stream tier
    # CLEARLY wins (slack escalation below can double its tables)
    if not force and 2 * est_stream >= est_block:
        return None, None
    heavy = (rcount > K_CAP)[rows]
    plan = build_stream_plan(rows[~heavy], cols[~heavy], vals[~heavy],
                             n_rows, n_cols, np_dtype)
    # Slack escalation by ESTIMATE: rebuild at s2=8 only when the residue
    # it removes costs more than the growth of the stage-2 tables (stage
    # 3 is collision-free by construction, see route.S3).
    added = (stream_cost_estimate(len(rows), k_est, n_rows, s2=8)
             - stream_cost_estimate(len(rows), k_est, n_rows))
    if int(plan.res_rows.shape[0]) * RES_NS > added:
        plan = build_stream_plan(rows[~heavy], cols[~heavy], vals[~heavy],
                                 n_rows, n_cols, np_dtype, s2=8)
    return plan, heavy


def prepare(m: BmSparse, dtype=None, force_layout=None,
            col_shift: int = 0, sell_unit: int | None = None,
            stream: str = "auto") -> Prepared:
    """Build the tiered execution plan (host-side numpy, once per matrix).

    dtype: storage dtype for the plan tiers; defaults to the matrix's
    own value dtype — bf16 matrices get bf16 tiers (half the memory
    traffic; the reference's half-input regime), f64 matrices get f64
    tiers (the reference's double instantiation).
    Accumulation is always promote(dtype, float32) in the ops.

    force_layout: optional (dia_offsets, groups) where groups is a tuple
    of (K, chunks) pairs in descending-K order. Forces the plan's STATIC
    structure — diagonals not in the matrix get zero strips, groups get
    padding chunks — so plans for different shards of a partitioned
    matrix become stackable for shard_map (see parallel/plan.py).

    col_shift: subtracted from column indices when assigning scalars to
    diagonals (the multi-chip path keeps columns global but rows shard-
    local; diagonal offset o then means v[row + col_shift + o]).

    sell_unit: SELL slot granularity in scalar columns (8 = one slot per
    8x8 block, 64 = super-slots merging a row's blocks that share a
    64-scalar column window). None = automatic (64 when the merge factor
    reaches 2x; see the tier-2 comment).

    stream: "auto" routes scattered structures to the stream tier by the
    cost model below; "force" routes every eligible sub-cap row there
    regardless of the estimate (tests / experiments); "off" disables the
    tier.
    """
    if isinstance(m, Prepared):
        return m
    if dtype is None:
        dtype = m.dtype if jnp.issubdtype(m.dtype, jnp.floating) \
            else jnp.float32
    np_dtype = np.dtype(dtype)

    rows, cols, vals = m.generate_coo(order="any")
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    vals = vals.astype(np_dtype)
    nbr = m.block_rows
    nbc = m.block_cols
    npad = nbr * BLOCK_HEIGHT
    forced_dia, forced_groups = force_layout if force_layout else (None, None)

    # ---- Tier 1: extract dense diagonals --------------------------------
    dia = None
    dia_offsets: tuple = ()
    if len(rows) or forced_dia:
        if forced_dia is not None:
            offs = np.asarray(forced_dia, np.int64)
        else:
            offs = _choose_diagonals(
                rows, cols, m.num_rows, m.num_cols, col_shift
            )
        if len(offs):
            dev = cols - rows - col_shift
            on_dia = np.isin(dev, offs)
            off_to_slot = {int(o): i for i, o in enumerate(offs)}
            d_slot = np.array(
                [off_to_slot[int(o)] for o in dev[on_dia]], np.int64
            )
            r128 = cdiv(npad, 128)
            dia_np = np.zeros((len(offs), r128, 128), np_dtype)
            r_dia = rows[on_dia]
            dia_np[d_slot, r_dia // 128, r_dia % 128] = vals[on_dia]
            dia = jnp.asarray(dia_np)
            dia_offsets = tuple(int(o) for o in offs)
            rows, cols, vals = rows[~on_dia], cols[~on_dia], vals[~on_dia]

    # ---- Tier 2: SELL-C-128 over the remaining blocks -------------------
    # Slot granularity: one gather index per SLOT. When a block-row's
    # columns cluster, merging its blocks into 64-scalar column-window
    # SUPER-slots (cw = 64) divides the per-slot v-gather count by the
    # merge factor (road networks ~4x; webgraphs/random ~1x and keep
    # cw = 8, since the 8x denser coefficient slabs would cost more than
    # the gathers they save).
    sell_dense: list = []
    sell_bcol: list = []
    sell_ks: list = []
    out_gather = None
    sell_rows = 0
    cw = 8
    stream_plan = None
    single = (forced_groups is None and col_shift == 0
              and sell_unit is None)
    nblk = nwin = 0
    if single and len(rows):
        br0 = rows >> 3
        nblk = len(np.unique(br0 * np.int64(nbc) + (cols >> 3)))
        nwin = len(np.unique(br0 * np.int64(cdiv(nbc, 8)) + (cols >> 6)))
    if (single and np_dtype.itemsize == 4 and np_dtype.kind == "f"
            and stream != "off"
            and (len(rows) >= 4096 or stream == "force")):
        stream_plan, keep = _route_stream(
            rows, cols, vals, nblk, nwin, m.num_rows, m.num_cols,
            np_dtype, force=(stream == "force"))
        if stream_plan is not None:
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
    # slot granularity for the block tiers (stream leftovers are a few
    # deep scattered rows — keep cw = 8)
    if sell_unit is not None:
        cw = int(sell_unit)
    elif (single and len(rows) and stream_plan is None
          and _use_superslots(nblk, nwin, np_dtype.itemsize)):
        cw = 64

    if len(rows) or forced_groups:
        ncu = cdiv(m.num_cols, cw)      # column units (cw scalars each)
        br = rows >> 3
        bc = cols // cw
        # slot order (j, i): sublane j*8+i so the contraction is a
        # contiguous 8-sublane slice per term (j runs over the cw window
        # scalars).
        slot = (cols % cw) * 8 + (rows & 7)
        bid = br * ncu + bc
        order = np.argsort(bid, kind="stable")
        br, bc, slot, vals, bid = (
            x[order] for x in (br, bc, slot, vals, bid)
        )
        ublocks, binv = np.unique(bid, return_inverse=True)
        ubr = (ublocks // ncu).astype(np.int64)
        ubc = (ublocks % ncu).astype(np.int64)

        # SELL-sigma row order is built inside _build_sell_tier.
        # Secondary key on the single-chip path: the row's minimum block
        # column, so equal-count rows cluster by column window and each
        # chunk's v gathers stay local. (Banded matrices get the same
        # effect from natural order; the sharded/halo paths keep the
        # natural tie-break so shard layouts stay reproducible across the
        # unified-statics union. They also keep the fixed K ladder —
        # sell_unit is not None marks them, and shard 0 has
        # col_shift == 0, so without the sell_unit check its pass-1 plan
        # would report adaptive K classes while other shards report
        # ladder values, corrupting the cross-shard union.)

        (sell_dense, sell_bcol, sell_ks,
         og, sell_rows) = _build_sell_tier(
            np.arange(len(ublocks)), ubr, ubc, slot, vals, binv, nbr, ncu,
            cw, np_dtype, forced_groups=forced_groups, adaptive=single,
            secondary_wlo=single,
        )
        out_gather = jnp.asarray(og)

    return Prepared(
        m=m, dense_flat_=None, plan_dtype=np.dtype(dtype).name,
        dia=dia, dia_offsets=dia_offsets,
        sell_dense=tuple(sell_dense), sell_bcol=tuple(sell_bcol),
        sell_ks=tuple(sell_ks),
        out_gather=out_gather, sell_rows=sell_rows,
        stream=stream_plan,
    )


def cast_prepared(p: Prepared, dtype) -> Prepared:
    """Re-dtype a Prepared plan's value tiers ON DEVICE (one jitted cast).

    Equivalent to prepare(m, dtype) — the tiers are values cast
    element-wise and the structure/index arrays are dtype-independent —
    without the host-side rebuild and re-upload.
    """
    np_dtype = np.dtype(dtype)
    if np_dtype == np.dtype(p.plan_dtype):
        return p
    cast = jax.jit(lambda x: x.astype(np_dtype))
    return dataclasses.replace(
        p,
        dense_flat_=None,
        plan_dtype=np_dtype.name,
        dia=None if p.dia is None else cast(p.dia),
        sell_dense=tuple(cast(d) for d in p.sell_dense),
    )


def as_matrix(x) -> BmSparse:
    return x.m if isinstance(x, Prepared) else x
