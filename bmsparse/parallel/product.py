"""Sharded cached SpGEMM products — the multi-chip fast path.

Round 1's `sharded_spgemm` all-gathers the ENTIRE B operand to every
shard and runs the slow jit-safe chunked numeric per shard: O(d) memory
per chip and no exploitation of the dependency structure. This module is
the refinement the design notes called for (parallel/spgemm.py:11-16):

  * The dependency set is exact: shard s needs B block gb iff one of its
    tasks multiplies by gb — the ``pos[col]`` dependency of the reference
    task creator (ref: src/bmSparse_SPGEMM.cu:134). For banded/clustered
    matrices this is a small fraction of B.
  * Exchange is SELECTIVE: at plan time each shard's needed set is
    grouped by owner; the runtime sends exactly those dense tiles with
    one fused `all_to_all` (pairs are padded to the max pair size so the
    program is static). Comm volume is sum(needed) instead of d*B.
  * Numeric is the task-SELL fast path (ops/spgemm.py): per-shard slot
    layouts, compress tables, and C container metadata are all planned on
    host ONCE per structure and stacked with unified statics (union of
    K-groups, max chunk counts) so shard_map runs one program with zero
    host syncs per multiply. The A-side tile gathers and the compress
    tables depend only on local data, so XLA overlaps them with the
    exchange.

Values may change between calls as long as structure is frozen — the
same contract as ops.product.PreparedProduct.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.bmsparse import BmSparse
from ..ops import spgemm as sg
from ..utils.timing import PhaseTimer
from .mesh import AXIS
from .partition import ShardedBmSparse


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedProduct:
    """Structure-frozen sharded C = A @ B with device-only numeric."""

    # stacked per-shard operand tiles
    a_flat: jax.Array       # (d, nb_a_max, 64)
    b_flat: jax.Array       # (d, nb_b_max, 64) — OWN B blocks per shard
    # selective exchange plan
    send_idx: jax.Array     # (d, d, max_send) int32 into own b_flat
    # task-SELL slot layouts, one array pair per unified K-group
    tas: tuple = ()         # each (d, cap, K, 128) int32 into a_flat
    tbs: tuple = ()         # each (d, cap, K, 128) int32 into b_needed
    # compress tables, row-aligned with the concatenated group rows
    sig_hi: jax.Array | None = None   # (d, R) uint32
    sig_lo: jax.Array | None = None
    sig_off: jax.Array | None = None
    # C container (values filled per multiply)
    cbrow: jax.Array | None = None    # (d, nbc_pad)
    cbcol: jax.Array | None = None
    c_hi: jax.Array | None = None
    c_lo: jax.Array | None = None
    c_offsets: jax.Array | None = None
    c_nb: jax.Array | None = None     # (d,)

    ks: tuple = dataclasses.field(metadata=dict(static=True), default=())
    caps: tuple = dataclasses.field(metadata=dict(static=True), default=())
    impl: str = dataclasses.field(metadata=dict(static=True),
                                  default="sell")
    # exchange strategy: "selective" (padded all_to_all of needed tiles)
    # or "allgather" (the skew fallback — when padding inflates the
    # selective wire volume past a full all-gather, e.g. webgraph hubs
    # making one shard need most of B, selective is a net loss and the
    # planner falls back automatically)
    exchange: str = dataclasses.field(metadata=dict(static=True),
                                      default="selective")
    nnz_pad: int = dataclasses.field(metadata=dict(static=True), default=1)
    nbc_pad: int = dataclasses.field(metadata=dict(static=True), default=1)
    max_send: int = dataclasses.field(metadata=dict(static=True), default=1)
    num_rows: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_cols: int = dataclasses.field(metadata=dict(static=True), default=0)
    rows_per_shard: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    # plan-time comm accounting (bytes per multiply, for the scaling
    # report). comm_bytes_selective charges the WIRE volume — every
    # off-diagonal pair padded to max_send, exactly what the all_to_all
    # moves — while comm_bytes_useful counts only real tiles (the
    # round-2 number, kept for the padding-overhead ratio).
    comm_bytes_selective: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    comm_bytes_useful: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    comm_bytes_allgather: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    # host-side planning wall time (seconds) for the whole prepare
    plan_seconds: float = dataclasses.field(
        metadata=dict(static=True), default=0.0)

    @property
    def num_shards(self) -> int:
        return self.a_flat.shape[0]


def prepare_sharded_product(
    sa: ShardedBmSparse, sb: ShardedBmSparse, impl: str = "auto"
) -> ShardedProduct:
    """Plan C = A @ B once per structure (host side).

    Runs the single-chip product planner per shard (A_s x B, global
    structure), remaps each shard's B-side slot indices onto its needed
    set, unifies the static layout across shards, and builds the
    selective exchange plan. impl selects the per-shard product kernel
    ("auto" | "sell" | "pallas", as in ops.spgemm.resolve_impl), stored on
    the plan for sharded_multiply.
    """
    import time as _time

    t_plan0 = _time.monotonic()
    impl = sg.resolve_impl(impl)
    if impl not in ("sell", "pallas"):
        raise ValueError(f"sharded products support 'sell'|'pallas', "
                         f"got {impl!r}")
    d = sa.num_shards
    if sb.num_shards != d:
        raise ValueError("operand shard counts differ")
    if sa.num_cols != sb.num_rows:
        raise ValueError(f"inner dims mismatch: {sa.num_cols} vs {sb.num_rows}")

    b_full = sb.to_bmsparse()
    nb_b = int(b_full.nb)
    # owner boundaries: to_bmsparse concatenates shard slices in order
    nb_per = [int(x) for x in np.asarray(sb.nb)]
    owner_starts = np.concatenate([[0], np.cumsum(nb_per)]).astype(np.int64)
    owner_of = np.zeros((nb_b + 1,), np.int64)
    for s in range(d):
        owner_of[owner_starts[s]:owner_starts[s + 1]] = s
    owner_of[nb_b] = d  # sentinel

    # decompress B ONCE and share it across the d per-shard plans (each
    # _plan_product would otherwise re-run the B-side decompress gather)
    class _BPrep:
        dense_flat = b_full.decompress_blocks_flat()

    timer = PhaseTimer(enabled=False)
    plans = []
    for s in range(d):
        a_s = sa.shard_local(s)
        plans.append(
            sg._plan_product(a_s, b_full, None, _BPrep, timer, False))

    # ---- unified static layout ------------------------------------------
    ks_all = sorted(
        {kg for p in plans for kg, _, _ in p.groups}, reverse=True
    )
    caps = []
    from ..config import bucket_size

    for kg in ks_all:
        cap = 1
        for p in plans:
            for k2, c0, c1 in p.groups:
                if k2 == kg:
                    cap = max(cap, bucket_size(c1 - c0, minimum=1))
        caps.append(cap)
    nnz_pad = max(p.nnz_pad for p in plans)
    nbc_pad = max(p.nb_pad_c for p in plans)
    nb_a_max = max(p.a_flat.shape[0] for p in plans)

    # ---- per-shard slot arrays + needed sets + compress tables ----------
    tas = [np.full((d, cap, kg, 128), nb_a_max, np.int32)
           for kg, cap in zip(ks_all, caps)]
    tbs_global = [np.full((d, cap, kg, 128), nb_b, np.int32)
                  for kg, cap in zip(ks_all, caps)]
    r_rows = sum(cap * 128 for cap in caps)
    sig_hi = np.zeros((d, r_rows), np.uint32)
    sig_lo = np.zeros((d, r_rows), np.uint32)
    sig_off = np.zeros((d, r_rows), np.int32)
    cbrow = np.full((d, nbc_pad), sa.block_rows, np.int32)
    cbcol = np.zeros((d, nbc_pad), np.int32)
    c_hi = np.zeros((d, nbc_pad), np.uint32)
    c_lo = np.zeros((d, nbc_pad), np.uint32)
    c_off = np.zeros((d, nbc_pad), np.int32)
    c_nb = np.zeros((d,), np.int32)
    a_flat = np.zeros((d, nb_a_max, 64), np.float32)
    needed = []          # per shard: sorted global ids of needed B blocks

    for s, p in enumerate(plans):
        af = np.asarray(p.a_flat, np.float32)
        a_flat[s, : af.shape[0]] = af
        sent_b_local = p.b_flat.shape[0]
        used = set()
        row0 = 0
        for gi, kg in enumerate(ks_all):
            cap = caps[gi]
            # find this shard's group with depth kg (if any)
            for k2, c0, c1 in p.groups:
                if k2 != kg:
                    continue
                ch = c1 - c0
                ch_pad = bucket_size(ch, minimum=1)
                ta, tb = sg._gather_group_slots(
                    p.keys_tbl, p.starts_sig, p.cnt_sig,
                    jnp.int32(c0), ch_pad, kg,
                    p.a_flat.shape[0], sent_b_local,
                )
                ta_h = np.asarray(ta)[:cap]
                tb_h = np.asarray(tb)[:cap]
                n_real = min(ch_pad, cap)
                tas[gi][s, :n_real] = np.where(
                    ta_h[:n_real] >= p.a_flat.shape[0], nb_a_max,
                    ta_h[:n_real])
                tbs_global[gi][s, :n_real] = np.where(
                    tb_h[:n_real] >= sent_b_local, nb_b, tb_h[:n_real])
                # sigma-ordered compress columns are plan data (carried
                # through the planner's sorts; no keys_tbl gather)
                nrows = min(ch, cap) * 128
                lo_r = c0 * 128
                rr = row0 + np.arange(nrows)
                sig_hi[s, rr] = np.asarray(
                    p.sig_sigma[0][lo_r:lo_r + nrows]).astype(np.uint32)
                sig_lo[s, rr] = np.asarray(
                    p.sig_sigma[1][lo_r:lo_r + nrows]).astype(np.uint32)
                sig_off[s, rr] = np.asarray(
                    p.sig_sigma[2][lo_r:lo_r + nrows])
            row0 += cap * 128
        if ks_all:
            gids = np.unique(np.concatenate(
                [t[s][t[s] < nb_b].reshape(-1) for t in tbs_global]
            )).astype(np.int64)
        else:
            gids = np.zeros((0,), np.int64)
        needed.append(gids)

        nb_c = p.num_c_blocks
        npd = min(p.nb_pad_c, nbc_pad)
        cbrow[s, :npd] = np.asarray(p.cbrow)[:npd]
        cbcol[s, :npd] = np.asarray(p.cbcol)[:npd]
        c_hi[s, :npd] = np.asarray(p.c_hi)[:npd]     # already validity-masked
        c_lo[s, :npd] = np.asarray(p.c_lo)[:npd]
        c_off[s, :npd] = np.asarray(p.c_off)[:npd]
        c_nb[s] = nb_c

    # ---- selective exchange plan + B-index remap ------------------------
    # A shard's OWN tiles never ride the exchange: the numeric gathers
    # read them straight from the local slab (b_needed = [exchanged ;
    # own slab ; sentinel]). max_send is therefore the largest
    # OFF-DIAGONAL pair — for banded structure the halo, not the slab
    # (round 2 padded every pair to the self-pair's full slab size).
    max_send = 1
    send_counts = np.zeros((d, d), np.int64)   # [src, dst]
    for s in range(d):
        for src in range(d):
            cnt = int(((needed[s] >= owner_starts[src])
                       & (needed[s] < owner_starts[src + 1])).sum())
            send_counts[src, s] = cnt
            if src != s:
                max_send = max(max_send, cnt)

    nb_b_max = max(max(nb_per), 1)
    b_flat_own = np.zeros((d, nb_b_max, 64), np.float32)
    bf_full = np.asarray(_BPrep.dense_flat, np.float32)
    for s in range(d):
        b_flat_own[s, : nb_per[s]] = bf_full[
            owner_starts[s]:owner_starts[s + 1]
        ]

    # wire bytes per multiply: the all_to_all pads EVERY off-diagonal
    # pair to max_send, and that padding crosses the link — charge it (the
    # round-2 accounting only counted real tiles and understated skewed
    # structure). Self->self slabs never leave the chip.
    off_diag = send_counts.sum() - np.trace(send_counts)
    useful_bytes = int(off_diag * 64 * 4)
    sel_bytes = int(d * (d - 1) * max_send * 64 * 4)
    allg_bytes = int(d * (d - 1) * nb_b_max * 64 * 4)
    # skew fallback: webgraph-like hub structure makes one shard need
    # most of B, ballooning max_send until the padded selective exchange
    # moves MORE than a plain all-gather of the owned slabs; at that
    # point all-gather is strictly better (same or fewer bytes, no
    # send-staging gather)
    exchange = "selective" if sel_bytes < allg_bytes else "allgather"

    send_idx = np.full((d, d, max_send), nb_b_max, np.int32)  # [src, dst]
    if exchange == "selective":
        # global id -> slot in the receiver's b_needed space: exchanged
        # off-diagonal tiles at owner*max_send + rank-within-pair, own
        # tiles at d*max_send + local (the local slab appended after the
        # exchange buffer); sentinel row last. gids are sorted so owner
        # regions are contiguous and searchsorted remaps in bulk.
        sent_slot = d * max_send + nb_b_max
        tbs = [np.full_like(t, sent_slot) for t in tbs_global]
        for s in range(d):
            gids = needed[s]
            owners = owner_of[gids]
            local = gids - owner_starts[owners]
            slot_arr = np.zeros((len(gids),), np.int64)
            for src in range(d):
                m = owners == src
                cnt = int(m.sum())
                if src == s:
                    slot_arr[m] = d * max_send + local[m]
                else:
                    send_idx[src, s, :cnt] = local[m]
                    slot_arr[m] = src * max_send + np.arange(cnt)
            for gi in range(len(ks_all)):
                tg = tbs_global[gi][s]
                real = tg < nb_b
                if real.any():
                    tbs[gi][s][real] = slot_arr[
                        np.searchsorted(gids, tg[real])
                    ]
    else:
        # all-gather layout: global id g lives at owner*nb_b_max + local
        tbs = []
        for gi in range(len(ks_all)):
            tg = np.minimum(tbs_global[gi], nb_b)
            owners = owner_of[tg]
            local = tg - owner_starts[np.minimum(owners, d - 1)]
            slot = np.where(
                tg < nb_b, owners * nb_b_max + local, d * nb_b_max
            ).astype(np.int32)
            tbs.append(slot)

    return ShardedProduct(
        a_flat=jnp.asarray(a_flat),
        b_flat=jnp.asarray(b_flat_own),
        send_idx=jnp.asarray(send_idx),
        tas=tuple(jnp.asarray(t) for t in tas),
        tbs=tuple(jnp.asarray(t) for t in tbs),
        sig_hi=jnp.asarray(sig_hi), sig_lo=jnp.asarray(sig_lo),
        sig_off=jnp.asarray(sig_off),
        cbrow=jnp.asarray(cbrow), cbcol=jnp.asarray(cbcol),
        c_hi=jnp.asarray(c_hi), c_lo=jnp.asarray(c_lo),
        c_offsets=jnp.asarray(c_off), c_nb=jnp.asarray(c_nb),
        ks=tuple(ks_all), caps=tuple(caps), impl=impl,
        exchange=exchange,
        nnz_pad=nnz_pad, nbc_pad=nbc_pad, max_send=max_send,
        num_rows=sa.num_rows, num_cols=sb.num_cols,
        rows_per_shard=sa.rows_per_shard,
        comm_bytes_selective=sel_bytes,
        comm_bytes_useful=useful_bytes,
        comm_bytes_allgather=allg_bytes,
        plan_seconds=float(_time.monotonic() - t_plan0),
    )


def _local_multiply(
    a_flat, b_flat, send_idx, shi, slo, soff, *tabs,
    nnz_pad: int, impl: str, exchange: str = "selective",
):
    """Per-shard body: B tile exchange + task-SELL numeric.

    exchange="selective": staged send buffers + one fused all_to_all of
    exactly the needed tiles (padded per pair). "allgather": the skew
    fallback — all shards receive every owned slab. The A-side transposed
    table and the slot gathers on it depend only on local data, so XLA
    can overlap them with the exchange."""
    af = a_flat[0]
    bf = b_flat[0]
    nb_b_max = bf.shape[0]
    if exchange == "selective":
        # send buffer: for each destination, the dense tiles it needs
        # from us (sentinel index nb_b_max -> zero row via the padded
        # table; the self row sends zeros — own tiles never ride the
        # exchange, they are read from the local slab appended below)
        bf_pad = jnp.concatenate([bf, jnp.zeros((1, 64), bf.dtype)])
        send = jnp.take(
            bf_pad, jnp.clip(send_idx[0], 0, nb_b_max), axis=0
        )                                    # (d, max_send, 64)
        # one fused all_to_all;
        # output row-block r holds the tiles shard r sent to us
        exch = jax.lax.all_to_all(
            send, AXIS, split_axis=0, concat_axis=0
        ).reshape(-1, 64)                    # (d*max_send, 64)
        b_needed = jnp.concatenate([exch, bf])  # + own slab
    else:
        b_needed = jax.lax.all_gather(
            bf, AXIS, tiled=True
        )                                    # (d*nb_b_max, 64)
    b_needed = jnp.concatenate(
        [b_needed, jnp.zeros((1, 64), bf.dtype)]
    )                                    # sentinel row last

    a_ext = jnp.concatenate([af, jnp.zeros((1, 64), af.dtype)])
    n = len(tabs) // 2
    parts = [
        sg._numeric_group(a_ext, b_needed, tabs[i][0], tabs[n + i][0], impl)
        for i in range(n)
    ]
    c_rows = parts[0] if n == 1 else jnp.concatenate(parts)
    cv = sg._compress_rows(
        c_rows, shi[0], slo[0], soff[0], nnz_pad
    )
    return cv[None]


# One jitted shard_map program per (static layout, mesh) — rebuilding
# jit(shard_map(...)) per call would retrace/recompile every multiply.
# The mesh is held WEAKLY
# (a WeakKeyDictionary level) so a dropped mesh releases its programs;
# within a mesh the key includes every static the program closes over.
# Note jit still retains one compiled executable per distinct traced
# shape set under each entry for the process lifetime — long-lived
# sessions multiplying many distinct plans retain all their executables.
_MULTIPLY_CACHE: "dict" = None


def _multiply_fn(nnz_pad: int, impl: str, exchange: str,
                 n_operands: int, mesh):
    import weakref

    global _MULTIPLY_CACHE
    if _MULTIPLY_CACHE is None:
        _MULTIPLY_CACHE = weakref.WeakKeyDictionary()
    per_mesh = _MULTIPLY_CACHE.setdefault(mesh, {})
    key = (nnz_pad, impl, exchange, n_operands)
    fn = per_mesh.get(key)
    if fn is None:
        from jax.sharding import PartitionSpec as P

        fn = jax.jit(jax.shard_map(
            partial(_local_multiply, nnz_pad=nnz_pad, impl=impl,
                    exchange=exchange),
            mesh=mesh,
            in_specs=(P(AXIS),) * n_operands,
            out_specs=P(AXIS),
            # the Pallas interpreter (CPU tests of impl="pallas") cannot
            # track varying manual axes through its grid loop
            check_vma=False,
        ))
        per_mesh[key] = fn
    return fn


def sharded_multiply(spp: ShardedProduct, mesh) -> ShardedBmSparse:
    """Run the planned product over the mesh; returns C sharded like A."""
    operands = [
        spp.a_flat, spp.b_flat, spp.send_idx,
        spp.sig_hi, spp.sig_lo, spp.sig_off,
        *spp.tas, *spp.tbs,
    ]
    fn = _multiply_fn(spp.nnz_pad, spp.impl, spp.exchange,
                      len(operands), mesh)
    values = fn(*operands)
    return ShardedBmSparse(
        brow=spp.cbrow, bcol=spp.cbcol,
        bmp_hi=spp.c_hi, bmp_lo=spp.c_lo,
        offsets=spp.c_offsets, values=values, nb=spp.c_nb,
        num_rows=spp.num_rows, num_cols=spp.num_cols,
        nnz=-1, transposed=False, rows_per_shard=spp.rows_per_shard,
    )
