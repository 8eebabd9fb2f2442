"""Multi-chip SpGEMM: C = A @ B with A and C block-row-partitioned.

Dependency structure (SURVEY.md §5): a shard owning A's block rows needs
B's block row k wherever its A blocks have block-column k — exactly the
``pos[col]`` lookup of the task creator (ref: src/bmSparse_SPGEMM.cu:134).
For general/unknown structure a shard may need any B row, so this module
exchanges B with one fused all-gather between devices (per-shard value offsets
are rebased by ``shard * nnz_max`` before the gather so the concatenated
value array stays addressable; the T1 row-start table is built with a
positional segment_min, which tolerates the padding blocks interleaved
between shard slices), then runs the jit-safe padded SpGEMM per shard.
This is the structure-oblivious path (and what dryrun compile checks
exercise); `parallel/product.py` is the fast path — host-planned
per-shard task-SELL numeric with a SELECTIVE all_to_all of exactly the
needed B tiles.

C inherits A's partition: every shard computes its own C rows with the
single-chip padded SpGEMM, keys stay globally sorted, and reassembly is a
concatenation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..format.bmsparse import BmSparse
from ..ops.spgemm import spgemm_padded
from .mesh import AXIS
from .partition import ShardedBmSparse


def _local_spgemm(
    a_brow, a_bcol, a_hi, a_lo, a_off, a_val, a_nb,
    b_brow, b_bcol, b_hi, b_lo, b_off, b_val, b_nb,
    *,
    a_meta: dict, b_meta: dict,
    max_tasks: int, max_c_blocks: int, max_c_nnz: int,
):
    s = jax.lax.axis_index(AXIS)

    # --- B halo exchange: all-gather every shard's slice  ---------
    nnzb_max = b_val.shape[1]
    b_off_rebased = b_off[0] + s * nnzb_max
    gb_brow = jax.lax.all_gather(b_brow[0], AXIS, tiled=True)
    gb_bcol = jax.lax.all_gather(b_bcol[0], AXIS, tiled=True)
    gb_hi = jax.lax.all_gather(b_hi[0], AXIS, tiled=True)
    gb_lo = jax.lax.all_gather(b_lo[0], AXIS, tiled=True)
    gb_off = jax.lax.all_gather(b_off_rebased, AXIS, tiled=True)
    gb_val = jax.lax.all_gather(b_val[0], AXIS, tiled=True)
    gb_nb = jax.lax.psum(b_nb[0], AXIS)

    b_full = BmSparse(
        brow=gb_brow, bcol=gb_bcol, bmp_hi=gb_hi, bmp_lo=gb_lo,
        offsets=jnp.clip(gb_off, 0, gb_val.shape[0] - 1),
        values=gb_val, nb=gb_nb,
        num_rows=b_meta["num_rows"], num_cols=b_meta["num_cols"],
        nnz=gb_val.shape[0], transposed=b_meta["transposed"],
    )
    a_local = BmSparse(
        brow=a_brow[0], bcol=a_bcol[0], bmp_hi=a_hi[0], bmp_lo=a_lo[0],
        offsets=a_off[0], values=a_val[0], nb=a_nb[0],
        num_rows=a_meta["num_rows"], num_cols=a_meta["num_cols"],
        nnz=a_val.shape[1], transposed=False,
    )
    c = spgemm_padded(
        a_local, b_full,
        max_tasks=max_tasks, max_c_blocks=max_c_blocks,
        max_c_nnz=max_c_nnz,
    )
    return (
        c.brow[None], c.bcol[None], c.bmp_hi[None], c.bmp_lo[None],
        c.offsets[None], c.values[None], c.nb[None],
    )


def sharded_spgemm(
    sa: ShardedBmSparse,
    sb: ShardedBmSparse,
    mesh: Mesh,
    max_tasks: int,
    max_c_blocks: int | None = None,
    max_c_nnz: int | None = None,
) -> ShardedBmSparse:
    """C = A @ B over the mesh; returns C sharded like A.

    `max_tasks` / `max_c_blocks` / `max_c_nnz` are per-shard static upper
    bounds (use `estimate_bounds` for a safe choice). Runs the chunked-XLA
    numeric (the only jit-safe variant); the task-SELL/pallas fast path
    for sharded products is parallel/product.py.
    """
    d = mesh.devices.size
    if sa.num_shards != d or sb.num_shards != d:
        raise ValueError("operand shard count must match mesh size")
    if sa.num_cols != sb.num_rows:
        raise ValueError(f"inner dims mismatch: {sa.num_cols} vs {sb.num_rows}")
    max_c_blocks = max_c_blocks or max_tasks
    max_c_nnz = max_c_nnz or max_c_blocks * 64

    a_meta = dict(num_rows=sa.num_rows, num_cols=sa.num_cols)
    b_meta = dict(
        num_rows=sb.num_rows, num_cols=sb.num_cols, transposed=sb.transposed
    )
    fn = jax.shard_map(
        partial(
            _local_spgemm,
            a_meta=a_meta, b_meta=b_meta,
            max_tasks=max_tasks,
            max_c_blocks=max_c_blocks,
            max_c_nnz=max_c_nnz,
        ),
        mesh=mesh,
        in_specs=(P(AXIS),) * 14,
        out_specs=(P(AXIS),) * 7,
    )
    brow, bcol, hi, lo, off, val, nb = fn(
        sa.brow, sa.bcol, sa.bmp_hi, sa.bmp_lo, sa.offsets, sa.values, sa.nb,
        sb.brow, sb.bcol, sb.bmp_hi, sb.bmp_lo, sb.offsets, sb.values, sb.nb,
    )
    return ShardedBmSparse(
        brow=brow, bcol=bcol, bmp_hi=hi, bmp_lo=lo,
        offsets=off, values=val, nb=nb,
        num_rows=sa.num_rows, num_cols=sb.num_cols,
        # C's true nnz is data-dependent and lives on device; -1 marks it
        # unknown (everywhere else .nnz is a true count — to_bmsparse()
        # recomputes the exact value from the bitmaps)
        nnz=-1,
        transposed=False, rows_per_shard=sa.rows_per_shard,
    )


def estimate_bounds(sa: ShardedBmSparse, sb: ShardedBmSparse) -> dict:
    """Host-side safe static bounds for sharded_spgemm.

    Computes the exact per-shard task counts (same arithmetic as the
    symbolic T1/T2 phases, done with numpy) and returns the max over
    shards, bucketed up.
    """
    import numpy as np

    from ..config import bucket_size

    b_brow = np.asarray(sb.brow)
    b_valid = (np.asarray(sb.bmp_hi) | np.asarray(sb.bmp_lo)) != 0
    nbr = sb.block_rows
    row_count = np.zeros((nbr + 1,), np.int64)
    np.add.at(row_count, np.clip(b_brow[b_valid], 0, nbr), 1)

    a_bcol = np.asarray(sa.bcol)
    a_valid = (np.asarray(sa.bmp_hi) | np.asarray(sa.bmp_lo)) != 0
    max_tasks = 1
    for s in range(sa.num_shards):
        cols = np.clip(a_bcol[s][a_valid[s]], 0, nbr - 1)
        max_tasks = max(max_tasks, int(row_count[cols].sum()))
    max_tasks = bucket_size(max_tasks)
    return dict(
        max_tasks=max_tasks,
        max_c_blocks=max_tasks,
        max_c_nnz=max_tasks * 64,  # hard upper bound: 64 slots per C block
    )
