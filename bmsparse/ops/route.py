"""Stream tier: SpMV for scattered structures through a static routing
network.

The reference covers webgraph-like matrices with its one gather kernel
(ref: src/bmSparse_SPMV.cu:84-189). The block tiers (ops/plan.py) read a
dense 8x8 (or 64x8) slab per slot, which on near-one-nonzero-per-block
structures (webgraphs, uniform random) is mostly zeros. This tier routes
individual scalars instead:

  1. PRODUCTS in column order. Scalar nnz are sorted by column at plan
     time and packed into column windows, so the v gather of every
     TILE_R-row tile reads one narrow window. The within-window slot
     order is chosen so each element's LANE already equals its
     destination lane — the first routing stage costs nothing.
  2. A STATIC ROUTING NETWORK delivers every product to its destination
     cell (k, row) of a natural-row-order SELL grid. Destinations are
     plan-time constants, so the movement decomposes into two row-wise
     gather stages bridged by transposes. Collisions (two elements
     wanting the same slack slot) are resolved at plan time; the few
     that do not fit fall back to one small gather + segment_sum.
  3. u = dense sum over the K axis — no scatter, no final permutation
     (the grid is in natural row order).

Everything data-dependent happens once in prepare(); the per-call op is
three gathers, two transposes, and dense sums, all plain XLA.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

W_STREAM = 1024        # v window width (scalars)
S2 = 4                 # stage-2 slack slots per (sub-row, dest lane)
# Stage-3 slack: with nq padded to a multiple of 128 the
# destination a = krank * (nq/128) + (row//128)//128 decomposes UNIQUELY
# into (krank, row-digit) — two elements share (slab, a) only if they
# share the row AND the krank, which is impossible (kranks are distinct
# within a row). Stage 3 is collision-free by construction, so one slot
# suffices.
S3 = 1
TILE_R = 32            # rows per v window (panel quota granularity)
EXTRA_ROWS = 4         # per-window-group row quota beyond ceil(m/128)
K_CAP = 64             # rows with more slots go to the block-SELL tier


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Static routing plan for one matrix's scattered slots."""

    vals_grid: jax.Array        # (R1, 128) coefficients, source order
    rel_grid: jax.Array         # (R1, 128) int32 window-relative cols
    ws: jax.Array               # (R1//TILE_R,) int32 window starts
    idx2: jax.Array             # (R2, S2, 128) int32 stage-2 tables
    idx3: jax.Array             # (R3, G3, 128) int32 stage-3 tables
    res_rows: jax.Array         # (nres,) int32 fallback rows (sorted)
    res_cols: jax.Array         # (nres,) int32
    res_vals: jax.Array         # (nres,)
    w: int = dataclasses.field(metadata=dict(static=True), default=W_STREAM)
    k: int = dataclasses.field(metadata=dict(static=True), default=0)
    nq: int = dataclasses.field(metadata=dict(static=True), default=0)
    nsub: int = dataclasses.field(metadata=dict(static=True), default=0)
    w3: int = dataclasses.field(metadata=dict(static=True), default=0)
    nahi: int = dataclasses.field(metadata=dict(static=True), default=0)
    vtab_len: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_rows: int = dataclasses.field(metadata=dict(static=True), default=0)


# Routing cost model (ops/plan.prepare and the depth cap below). The
# constants are fitted to SpMV times on an NVIDIA H100 80GB HBM3 at a
# 400 W power limit (web, uniform-random, road and blockdense suite
# matrices; PERF.md), each taken at its least favourable fit for the
# stream tier:
STREAM_BW = 1.19e12    # stream-tier model bytes per second of stream_apply
BLOCK_BW = 2.64e12     # a plain copy's bytes per second, same run
GATHER_NS = 0.024e-9   # block tiers: per gathered v value, beyond the slab
RES_NS = 0.06e-9       # per residue element (gather + segment_sum)


def stream_cost_estimate(
    nnz: int, k: int, n_rows: int, s2: int = S2, s3: int = S3,
) -> float:
    """Estimated per-SpMV seconds of the stream tier: the bytes of its
    tables and transients at the tier's measured STREAM_BW. Used by
    ops/plan.prepare to route between the block SELL tiers and this
    tier."""
    nq = -(-(-(-n_rows // 128)) // 128) * 128  # padded (see S3 note)
    r1 = 1.45 * max(nnz, 1) / 128 + TILE_R     # quota slack + padding
    nahi = max(-(-(-(-(k * nq) // 128)) // 128), 1)
    g3 = nahi * s3
    grids = r1 * 128 * 8                       # vals + rel
    idx2 = r1 * 128 * s2 * 4
    idx3 = 16384 * g3 * 128 * 4
    transients = 6 * r1 * 128 * 4              # t1/a2/x3/a3 reads+writes
    return (grids + idx2 + idx3 + transients) / STREAM_BW


def build_stream_plan(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    n_rows: int, n_cols: int, np_dtype=np.float32,
    s2: int = S2, s3: int = S3,
) -> StreamPlan:
    """Plan-time construction (host numpy, once per matrix).

    rows/cols are SCALAR coordinates; every row must have <= K_CAP
    entries (the caller routes heavier rows to the block-SELL tier).
    s2/s3 override the default slack factors: locally-clustered
    structures (road networks) collide in the stage-2/3 tables far more
    than webgraphs — the caller escalates slack until the residue is
    small (the tables grow linearly with slack).
    """
    nnz = len(rows)
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    vals = vals.astype(np_dtype)

    # ---- destination cells: (k, row) of a (K, nq*128) grid ------------
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]
    krank = np.arange(nnz) - np.searchsorted(rows, rows)
    kmax = int(krank.max()) + 1 if nnz else 1
    assert kmax <= K_CAP, kmax
    # Depth cap: the grid's K axis is sized by the DEEPEST stream row,
    # but the stage-3 tables and the final K-sum are billed on every row,
    # so a thin tail of deep rows can double the tables. Pick the cap by
    # the same cost model that routes matrices here:
    # table cost at depth k plus residue cost for the overflow ranks.
    k = kmax
    if nnz:
        depth = np.bincount(rows)
        depth = depth[depth > 0]
        best, best_cost = kmax, None
        for kc in range(max(int(np.percentile(depth, 90)), 1), kmax + 1):
            ovf = int(np.maximum(depth - kc, 0).sum())
            cost = stream_cost_estimate(
                nnz - ovf, kc, n_rows, s2, s3) + ovf * RES_NS
            if best_cost is None or cost < best_cost:
                best, best_cost = kc, cost
        k = best
    deep = krank >= k
    deep_rows = rows[deep].astype(np.int32)
    deep_cols = cols[deep].astype(np.int32)
    deep_vals = vals[deep]
    if deep.any():
        rows, cols, vals = rows[~deep], cols[~deep], vals[~deep]
        krank = krank[~deep]
        nnz = len(rows)
    # nq padded to a multiple of 128: b = dr % 128 then depends on the
    # row alone and a = dr // 128 = krank*(nq/128) + (row//128)//128
    # decomposes uniquely -> stage 3 is collision-free at s3 = 1 (the
    # S3 note above). Costs k * pad * 512 bytes of all-zero grid rows.
    nq = -(-(-(-n_rows // 128)) // 128) * 128
    dr = krank * np.int64(nq) + rows // 128      # dest row in (k*nq, 128)
    dl = (rows % 128).astype(np.int64)           # dest lane
    a = dr // 128
    b = dr % 128
    a_count = -(-(k * nq) // 128)      # distinct a values
    nahi = max(-(-a_count // 128), 1)
    ahi = (a // 128).astype(np.int64)
    amod = (a % 128).astype(np.int64)

    # ---- source packing: column windows, lane = dest lane -------------
    co = np.argsort(cols, kind="stable")
    # group boundaries: greedy W_STREAM-aligned windows of W_STREAM
    # scalars; a new group starts where col >= current end.
    ws_of_group: list = []
    sorted_cols = cols[co]
    starts = []
    i = 0
    while i < nnz:
        ws = int(sorted_cols[i]) // W_STREAM * W_STREAM
        starts.append(i)
        ws_of_group.append(ws)
        i = int(np.searchsorted(sorted_cols, ws + W_STREAM, side="left"))
    starts.append(nnz)
    ngroups = len(ws_of_group)

    r1_of = np.full((nnz,), -1, np.int64)
    lane_of = dl[co]
    row_base = 0
    tile_ws = []
    res_mask = np.zeros((nnz,), bool)
    for gi in range(ngroups):
        s, e = starts[gi], starts[gi + 1]
        m = e - s
        lanes = lane_of[s:e]
        # Row quota from the group's actual WORST lane, not the mean
        # (a mean-based quota leaves every lane beyond it in the
        # residue); a cap keeps one pathological hot lane (hub rows
        # sharing row%128 inside one window) from padding the whole
        # group's rows — its tail overflows to the residue.
        maxlane = int(np.bincount(lanes, minlength=128).max()) if m else 0
        quota = min(maxlane, 2 * (-(-m // 128)) + 4 * EXTRA_ROWS)
        # rounded to TILE_R rows (all of a tile's rows share one window)
        quota = max(-(-quota // TILE_R) * TILE_R, TILE_R)
        # j-th slot of each lane -> row j (within the group)
        order = np.lexsort((np.arange(m), lanes))
        ranks = np.empty((m,), np.int64)
        ranks[order] = np.arange(m) - np.searchsorted(
            lanes[order], lanes[order])
        ok = ranks < quota
        r1_of[s:e] = np.where(ok, row_base + ranks, -1)
        res_mask[s:e] = ~ok
        row_base += quota
        tile_ws.extend([ws_of_group[gi]] * (quota // TILE_R))
    r1_count = row_base
    # nsub rounded so nsub*s2 is a multiple of 128: stage-3's x3 width
    # then equals w3 exactly and stream_apply's pad-concat (a full copy
    # of the 16384-row stage-3 operand) vanishes. Costs a few all-zero
    # pad rows, which read an all-zero window at 0.
    nsub_mult = 128 // np.gcd(s2, 128)
    nsub = -(-max(-(-r1_count // 128), 1) // nsub_mult) * nsub_mult
    r1_pad = nsub * 128
    tile_ws.extend([0] * (r1_pad // TILE_R - len(tile_ws)))

    # scatter coefficients / relative columns into the source grid
    vals_grid = np.zeros((r1_pad, 128), np_dtype)
    rel_grid = np.zeros((r1_pad, 128), np.int32)
    okm = r1_of >= 0
    src_r = r1_of[okm]
    src_l = lane_of[okm]
    gws = np.repeat(np.asarray(ws_of_group, np.int64),
                    np.diff(np.asarray(starts)))
    vals_grid[src_r, src_l] = vals[co][okm]
    rel_grid[src_r, src_l] = (sorted_cols[okm] - gws[okm]).astype(np.int32)

    # ---- stage 2: (l, sub) rows -> lane b, slack S2 --------------------
    # element position after T1: row (l, r1 // 128), lane r1 % 128
    e_l = src_l
    e_sub = src_r // 128
    e_srclane = src_r % 128
    orig = co[okm]                                # original element index
    e_b = b[orig]
    e_ahi = ahi[orig]
    e_amod = amod[orig]

    r2 = 128 * nsub
    key2 = (e_l * nsub + e_sub) * 128 + e_b
    o2 = np.lexsort((np.arange(len(key2)), key2))
    rank2 = np.empty((len(key2),), np.int64)
    rank2[o2] = np.arange(len(key2)) - np.searchsorted(
        key2[o2], key2[o2])
    fit2 = rank2 < s2
    idx2 = np.full((r2, s2, 128), 128, np.int32)
    idx2[(e_l * nsub + e_sub)[fit2], rank2[fit2], e_b[fit2]] = \
        e_srclane[fit2]

    # ---- stage 3: (l, b) slabs -> (ahi, amod), slack S3 ----------------
    # element position after the T2 swap: slab l*128 + b,
    # column sub * S2 + rank2
    g3 = nahi * s3
    w3 = -(-(nsub * s2) // 128) * 128
    slab = e_l * 128 + e_b
    c3 = e_sub * s2 + rank2
    key3 = (slab * nahi + e_ahi) * 128 + e_amod
    valid3 = fit2
    key3m = np.where(valid3, key3, np.int64(-1))
    o3 = np.lexsort((np.arange(len(key3m)), key3m))
    rank3 = np.empty((len(key3m),), np.int64)
    rank3[o3] = np.arange(len(key3m)) - np.searchsorted(
        key3m[o3], key3m[o3])
    fit3 = valid3 & (rank3 < s3)
    # the padded-nq decomposition makes stage 3 collision-free (S3 note)
    assert nnz == 0 or not (valid3 & (rank3 > 0)).any()
    idx3 = np.full((16384, g3, 128), w3, np.int32)
    idx3[slab[fit3], (e_ahi * s3 + rank3)[fit3], e_amod[fit3]] = \
        c3[fit3].astype(np.int32)

    # ---- residue: depth-cap overflow + anything that missed a slot ----
    res_mask[np.nonzero(okm)[0][~fit3]] = True
    res_ids = co[res_mask]                        # original order ids
    rr = np.concatenate([rows[res_ids].astype(np.int32), deep_rows])
    rc = np.concatenate([cols[res_ids].astype(np.int32), deep_cols])
    rv = np.concatenate([vals[res_ids], deep_vals])
    rorder = np.argsort(rr, kind="stable")
    res_rows = rr[rorder]
    res_cols = rc[rorder]
    res_vals = rv[rorder]

    vtab_len = max(int(max(ws_of_group, default=0)) + W_STREAM,
                   W_STREAM)
    vtab_len = -(-vtab_len // 1024) * 1024

    return StreamPlan(
        vals_grid=jnp.asarray(vals_grid),
        rel_grid=jnp.asarray(rel_grid),
        ws=jnp.asarray(np.asarray(tile_ws, np.int32)),
        idx2=jnp.asarray(idx2),
        idx3=jnp.asarray(idx3),
        res_rows=jnp.asarray(res_rows),
        res_cols=jnp.asarray(res_cols),
        res_vals=jnp.asarray(res_vals),
        w=W_STREAM, k=k, nq=nq, nsub=nsub, w3=w3, nahi=nahi,
        vtab_len=vtab_len, n_rows=n_rows,
    )


def _window_product(vals, rel, ws, vtab):
    """products[r, l] = vals[r, l] * vtab[ws[r // TILE_R] + rel[r, l]].
    Padding slots carry rel == 0 and vals == 0."""
    base = jnp.repeat(ws, TILE_R)[:, None]
    return vals.astype(jnp.float32) * jnp.take(vtab, base + rel)


def _rowwise_gather(x, idx, g_out: int):
    """out[r, g, l] = x[r, idx[r, g, l]], 0.0 where idx == x.shape[1]."""
    r = x.shape[0]
    xz = jnp.concatenate([x, jnp.zeros((r, 1), x.dtype)], axis=1)
    return jnp.take_along_axis(
        xz, idx.reshape(r, -1), axis=1).reshape(r, g_out, 128)


def stream_apply(p: StreamPlan, vpad: jax.Array) -> jax.Array:
    """u_stream (n_rows,) = the planned slots' contribution to A @ v.

    vpad: (>= num_cols,) f32 dense vector (zero-padded).
    """
    vtab = jnp.zeros((p.vtab_len,), jnp.float32)
    nfill = min(p.vtab_len, vpad.shape[0])
    vtab = vtab.at[:nfill].set(vpad[:nfill].astype(jnp.float32))

    s2 = p.idx2.shape[1]
    s3 = p.idx3.shape[1] // p.nahi
    a1 = _window_product(p.vals_grid, p.rel_grid, p.ws, vtab)
    t1 = a1.T.reshape(128 * p.nsub, 128)              # (l, sub) rows
    a2 = _rowwise_gather(t1, p.idx2, s2)              # (R2, s2, 128)
    a2v = a2.reshape(128, p.nsub, s2, 128)
    x3 = jnp.transpose(a2v, (0, 3, 1, 2)).reshape(16384, p.nsub * s2)
    if x3.shape[1] < p.w3:
        x3 = jnp.concatenate(
            [x3, jnp.zeros((16384, p.w3 - x3.shape[1]), x3.dtype)],
            axis=1)
    a3 = _rowwise_gather(x3, p.idx3, p.nahi * s3)     # (16384, G3, 128)
    f = a3.reshape(128, 128, p.nahi, s3, 128).sum(axis=3)
    grid = jnp.transpose(f, (2, 3, 1, 0)).reshape(-1, 128)
    grid = grid[: p.k * p.nq]
    u = grid.reshape(p.k, p.nq, 128).sum(axis=0).reshape(-1)

    if p.res_rows.shape[0]:
        contrib = p.res_vals.astype(jnp.float32) * jnp.take(
            vtab, p.res_cols)
        u = u + jax.ops.segment_sum(
            contrib, p.res_rows, num_segments=p.nq * 128,
            indices_are_sorted=True)
    return u[: p.n_rows]
