"""Multi-chip SpMV: u = A @ v with A block-row-partitioned over a 1-D mesh.

Communication pattern (BASELINE.json north star / SURVEY.md §5): each shard
owns a contiguous block-row range of A and the matching slice of u; the
input vector v is sharded the same way, and the halo exchange is an
all-gather of v between devices (a shard needs v entries for every block column
it touches; for general sparsity that is the full vector, and one fused
XLA all-gather is the bandwidth-optimal way to get it). Compute is the
standard single-chip SpMV on the local shard — padding blocks contribute
zeros, so no masking is needed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import BLOCK_HEIGHT, BLOCK_WIDTH, round_up
from ..format.bmsparse import BmSparse
from ..ops.spmv import _spmv_xla
from .mesh import AXIS
from .partition import ShardedBmSparse


def _local_spmv(
    brow, bcol, hi, lo, offsets, values, nb, v_local,
    *, rows_per_shard: int, num_cols: int, nnz_max: int, v_len: int,
):
    """Per-shard body: all-gather v, run local SpMV on owned block rows."""
    s = jax.lax.axis_index(AXIS)
    v_full = jax.lax.all_gather(v_local[0], AXIS, tiled=True)[:v_len]
    local = BmSparse(
        brow=brow[0] - s * rows_per_shard,  # localize row ids
        bcol=bcol[0], bmp_hi=hi[0], bmp_lo=lo[0],
        offsets=offsets[0], values=values[0], nb=nb[0],
        num_rows=rows_per_shard * BLOCK_HEIGHT,
        num_cols=num_cols, nnz=nnz_max, transposed=False,
    )
    u_local = _spmv_xla(local, v_full)
    return u_local[None, :]


def sharded_spmv(sm: ShardedBmSparse, v: jax.Array, mesh: Mesh) -> jax.Array:
    """u = A @ v over the mesh. Returns the full u (length num_rows)."""
    if sm.transposed:
        raise ValueError("SpMV expects an untransposed matrix")
    d = mesh.devices.size
    if sm.num_shards != d:
        raise ValueError(f"matrix has {sm.num_shards} shards, mesh has {d}")
    # v sharded over the mesh; padded so the shard size is uniform.
    v_len = round_up(sm.num_cols, BLOCK_WIDTH)
    v_pad = round_up(v_len, d)
    vg = jnp.zeros((v_pad,), v.dtype).at[: v.shape[0]].set(v)
    vg = vg.reshape(d, v_pad // d)

    fn = jax.shard_map(
        partial(
            _local_spmv,
            rows_per_shard=sm.rows_per_shard,
            num_cols=sm.num_cols,
            nnz_max=sm.nnz_max,
            v_len=v_len,
        ),
        mesh=mesh,
        in_specs=(P(AXIS),) * 8,
        out_specs=P(AXIS),
    )
    u = fn(sm.brow, sm.bcol, sm.bmp_hi, sm.bmp_lo,
           sm.offsets, sm.values, sm.nb, vg)
    return u.reshape(-1)[: sm.num_rows]


def _local_spmv_prepared(
    dia, out_gather, v_local, *sell_arrays,
    dia_offsets, sell_ks, rows_per_shard, num_cols, v_len,
    num_shards, halo=None,
):
    """Per-shard tiered SpMV body (the fast path).

    Exchange: with `halo` (plan-proven single-neighbour column windows)
    only the two halo slices move — ppermute left + right, O(1)
    bytes per chip instead of the all-gather's O(v). Without it, v is
    all-gathered (general sparsity needs the full vector)."""
    from ..ops.spmv import dia_apply, sell_apply

    s = jax.lax.axis_index(AXIS)
    npad_loc = rows_per_shard * BLOCK_HEIGHT
    d = num_shards
    if halo is not None:
        hl, hr = halo
        own = v_local[0].astype(jnp.float32)
        chunk = own.shape[0]
        pieces = []
        if hl:
            left = jax.lax.ppermute(
                own[chunk - hl:], AXIS,
                [(i, (i + 1) % d) for i in range(d)],
            )
            pieces.append(jnp.where(s > 0, left, 0.0))
        pieces.append(own)
        if hr:
            right = jax.lax.ppermute(
                own[:hr], AXIS, [(i, (i - 1) % d) for i in range(d)],
            )
            pieces.append(jnp.where(s < d - 1, right, 0.0))
        vpad = jnp.concatenate(pieces) if len(pieces) > 1 else pieces[0]
        n = chunk + hl + hr
        dia_shift = s * (npad_loc - chunk) + hl
        dia_max_rows = ((d - 1) * max(npad_loc - chunk, 0) + hl) // 128
        sell_base = s * (chunk // BLOCK_WIDTH) - hl // BLOCK_WIDTH
        sentinel = -(-num_cols // BLOCK_WIDTH)
    else:
        v_full = jax.lax.all_gather(v_local[0], AXIS, tiled=True)[:v_len]
        n = round_up(num_cols, BLOCK_WIDTH)
        vpad = jnp.zeros((n,), jnp.float32).at[: v_full.shape[0]].set(
            v_full.astype(jnp.float32)
        )
        dia_shift = s * npad_loc
        # tall matrices: late shards' bases exceed n; size the slice
        # source for the largest base so dynamic_slice never clamps
        dia_max_rows = ((num_shards - 1) * npad_loc) // 128
        sell_base = None
        sentinel = None

    u = jnp.zeros((npad_loc,), jnp.float32)
    if dia_offsets:
        u2 = dia_apply(
            dia[0], dia_offsets, vpad, n,
            col_shift=dia_shift,
            max_shift_rows=dia_max_rows,
        )
        u = u + u2.reshape(-1)[:npad_loc]
    if sell_ks:
        ng = len(sell_arrays) // 2
        dense = tuple(x[0] for x in sell_arrays[:ng])
        bcol = tuple(x[0] for x in sell_arrays[ng:])
        u_sell = sell_apply(
            dense, bcol, out_gather[0], vpad, n // BLOCK_WIDTH,
            col_base=sell_base, global_sentinel=sentinel,
        )
        u = u + u_sell.reshape(npad_loc)
    return u[None, :]


def sharded_spmv_prepared(
    sp, v: jax.Array, mesh: Mesh, exchange: str = "auto",
) -> jax.Array:
    """u = A @ v over the mesh using the tiered per-shard plans
    (parallel/plan.py::prepare_sharded) — the multi-chip fast path.

    exchange: "halo" (plan-proven neighbour windows; ppermute of two
    halo slices — O(halo) bytes per device), "allgather" (full v), or "auto"
    (halo whenever the plan proved it feasible).
    """
    sm = sp.sm
    d = mesh.devices.size
    if sm.num_shards != d:
        raise ValueError(f"matrix has {sm.num_shards} shards, mesh has {d}")
    if exchange == "auto":
        exchange = "halo" if sp.halo is not None else "allgather"
    if exchange == "halo" and sp.halo is None:
        raise ValueError("plan has no feasible halo (multi-neighbour "
                         "window); use exchange='allgather'")
    halo = sp.halo if exchange == "halo" else None

    v_len = round_up(sm.num_cols, BLOCK_WIDTH)
    # 128-aligned chunks keep every halo/dia shift a multiple of 128
    v_pad = round_up(v_len, 128 * d)
    vg = jnp.zeros((v_pad,), v.dtype).at[: v.shape[0]].set(v)
    vg = vg.reshape(d, v_pad // d)

    dia_op = (
        sp.dia if sp.dia is not None
        else jnp.zeros((d, 1, 1, 128), jnp.float32)
    )
    operands = [dia_op, sp.out_gather, vg, *sp.sell_dense, *sp.sell_bcol]
    specs = (P(AXIS),) * len(operands)

    fn = jax.shard_map(
        partial(
            _local_spmv_prepared,
            dia_offsets=sp.dia_offsets,
            sell_ks=sp.sell_ks,
            rows_per_shard=sm.rows_per_shard,
            num_cols=sm.num_cols,
            v_len=v_len,
            num_shards=d,
            halo=halo,
        ),
        mesh=mesh,
        in_specs=specs,
        out_specs=P(AXIS),
    )
    u = fn(*operands)
    return u.reshape(-1)[: sm.num_rows].astype(v.dtype)
