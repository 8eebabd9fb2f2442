"""COO / CSR <-> BmSparse conversion — the reference's format-construction
pipeline (`bmSpMatrix(path, transposed)` ctor, ref: src/bmSpMatrix.cu:111-219)
restated as jit-compiled XLA sort + segment primitives:

  thrust::sort(block_order)        -> lax.sort with lexicographic int32 keys
  transform(coord_to_key)          -> (brow, bcol) pair (no u64 keys)
  reduce_by_key(keys, ones)        -> segment boundaries + segment_sum
  exclusive_scan -> offsets        -> cumsum
  reduce_by_key(coord_to_bmp, |)   -> segment_sum of one-hot bit words
                                      (bits are disjoint, so + == OR)

Everything runs on device with static shapes: the jitted core returns
nnz-sized padded block arrays plus the true block count; `coo_to_bmsparse`
optionally compacts on host (mirroring the reference's device->host
`block_num` sync at src/bmSpMatrix.cu:192).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BLOCK_HEIGHT, BLOCK_WIDTH, bucket_size
from . import bitmap as bm
from .bmsparse import BmSparse, cdiv


@partial(jax.jit, static_argnames=("transposed", "num_block_rows"))
def _coo_to_bmsparse_core(
    rows: jax.Array, cols: jax.Array, vals: jax.Array,
    transposed: bool, num_block_rows: int,
):
    """Jitted conversion core. All outputs padded to nnz entries.

    Returns (brow, bcol, bmp_hi, bmp_lo, offsets, values_sorted, nb) where
    entries at index >= nb are padding (bmp == 0, brow == num_block_rows).
    """
    n = rows.shape[0]
    brow_e = rows // BLOCK_HEIGHT
    bcol_e = cols // BLOCK_WIDTH
    rel_i = rows % BLOCK_HEIGHT
    rel_j = cols % BLOCK_WIDTH

    # Sort elements into block order, intra-block by bit address
    # (ref block_order functor: src/bmSpMatrix.cu:46-74 — row-major
    # (row, col) normally, (col, row) when transposed).
    intra = (rel_j * 8 + rel_i) if transposed else (rel_i * 8 + rel_j)
    (_, _, _, rows_s, cols_s, vals_s) = jax.lax.sort(
        (brow_e, bcol_e, intra.astype(jnp.int32), rows, cols, vals),
        num_keys=3,
    )

    brow_s = rows_s // BLOCK_HEIGHT
    bcol_s = cols_s // BLOCK_WIDTH
    # Segment ids: new segment whenever the block key changes
    # (reduce_by_key analogue).
    same = jnp.logical_and(
        brow_s[1:] == brow_s[:-1], bcol_s[1:] == bcol_s[:-1]
    )
    new_block = jnp.concatenate(
        [jnp.ones((1,), jnp.int32), 1 - same.astype(jnp.int32)]
    )
    seg = jnp.cumsum(new_block) - 1              # (n,) block index per elem
    nb = seg[-1] + 1 if n > 0 else jnp.int32(0)

    # Per-block key arrays: scatter first-element-of-segment -> position seg.
    brow_b = jnp.full((n,), num_block_rows, jnp.int32).at[seg].set(brow_s.astype(jnp.int32))
    bcol_b = jnp.zeros((n,), jnp.int32).at[seg].set(bcol_s.astype(jnp.int32))

    # Per-block nnz and offsets (exclusive scan; ref: src/bmSpMatrix.cu:190).
    counts = jax.ops.segment_sum(
        jnp.ones((n,), jnp.int32), seg, num_segments=n
    )
    offsets = (jnp.cumsum(counts) - counts).astype(jnp.int32)
    # Clamp padding offsets into range so padded decompression stays in-bounds.
    offsets = jnp.where(
        jnp.arange(n) < nb, offsets, jnp.maximum(n - 1, 0)
    ).astype(jnp.int32)

    # Bitmaps: OR of one-hot words per block. Bits are distinct within a
    # block (no duplicate coordinates), so segment_sum == OR
    # (ref coord_to_bmp + bmp_sum: src/bmSpMatrix.cu:85-109).
    e_hi, e_lo = bm.coords_to_words(
        (rows_s % BLOCK_HEIGHT).astype(jnp.int32),
        (cols_s % BLOCK_WIDTH).astype(jnp.int32),
        transposed,
    )
    bmp_hi = jax.ops.segment_sum(e_hi.astype(jnp.uint32), seg, num_segments=n)
    bmp_lo = jax.ops.segment_sum(e_lo.astype(jnp.uint32), seg, num_segments=n)

    return brow_b, bcol_b, bmp_hi, bmp_lo, offsets, vals_s, nb


def _coo_to_bmsparse_host(rows, cols, vals, shape, transposed):
    """Pure-numpy conversion — the reference's host-side converter
    (`mmread_bmSparse`, ref: src/reader.cu:49-110) done with vectorized
    numpy instead of a std::map. Used when the triplets are host arrays:
    it avoids a device round-trip and a fresh XLA compilation of the
    conversion pipeline per (nnz-shape).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    nbc = cdiv(shape[1], BLOCK_WIDTH)
    if len(rows) == 0:
        # mirror the device path's empty-input convention: one padding
        # block with a zero bitmap, nb == 0
        dtype = (vals.dtype if np.issubdtype(vals.dtype, np.floating)
                 else np.float32)
        nbr = cdiv(shape[0], BLOCK_HEIGHT)
        return BmSparse(
            brow=jnp.full((1,), nbr, jnp.int32),
            bcol=jnp.zeros((1,), jnp.int32),
            bmp_hi=jnp.zeros((1,), jnp.uint32),
            bmp_lo=jnp.zeros((1,), jnp.uint32),
            offsets=jnp.zeros((1,), jnp.int32),
            values=jnp.zeros((1,), dtype),
            nb=jnp.int32(0),
            num_rows=shape[0], num_cols=shape[1], nnz=0,
            transposed=transposed,
        )
    intra = (
        (cols % 8) * 8 + (rows % 8) if transposed
        else (rows % 8) * 8 + (cols % 8)
    )
    bid = (rows >> 3) * nbc + (cols >> 3)
    # one combined int64 sort key (block id is < 2^58 for any plausible
    # shape) — a single-key argsort runs ~3x faster than the old two-key
    # lexsort at 35M nnz, and element order within a (bid, intra) tie is
    # irrelevant (ties are duplicates, summed below)
    key = bid * np.int64(64) + intra
    order = np.argsort(key)
    key, vals = key[order], vals[order]
    dup = key[1:] == key[:-1]
    if dup.any():
        # duplicate (row, col) entries would corrupt the format (bitmap
        # popcount < stored value count); sum them like scipy/cusp COO
        # assembly does
        key_new = np.concatenate([[True], ~dup])
        grp = np.cumsum(key_new) - 1
        vsum = np.zeros(grp[-1] + 1, vals.dtype)
        np.add.at(vsum, grp, vals)
        keep = np.nonzero(key_new)[0]
        key, vals = key[keep], vsum
    bid, intra = np.divmod(key, np.int64(64))
    # block boundaries straight off the sorted stream (bid is sorted, so
    # no second sort à la np.unique)
    first = np.concatenate([[True], bid[1:] != bid[:-1]])
    start = np.nonzero(first)[0]
    nb = len(start)
    counts = np.diff(np.concatenate([start, [len(bid)]]))
    ublk = bid[start]
    brow = (ublk // nbc).astype(np.int32)
    bcol = (ublk % nbc).astype(np.int32)
    offsets = start.astype(np.int32)
    # bitmaps: segment-reduce of disjoint one-hot words (add == OR);
    # reduceat over the sorted stream replaces np.bitwise_or.at, which
    # runs ~50x slower (element-at-a-time ufunc dispatch)
    words = np.uint64(1) << (np.uint64(63) - intra.astype(np.uint64))
    bmp = np.add.reduceat(words, start)
    hi = (bmp >> np.uint64(32)).astype(np.uint32)
    lo = (bmp & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    dtype = vals.dtype if np.issubdtype(vals.dtype, np.floating) else np.float32
    vals = vals.astype(dtype)
    m = BmSparse(
        brow=jnp.asarray(brow), bcol=jnp.asarray(bcol),
        bmp_hi=jnp.asarray(hi), bmp_lo=jnp.asarray(lo),
        offsets=jnp.asarray(offsets), values=jnp.asarray(vals),
        nb=jnp.int32(nb),
        num_rows=shape[0], num_cols=shape[1], nnz=len(vals),
        transposed=transposed,
    )
    # register host copies: every later host-side consumer (generate_coo,
    # plan building, npz dumps) reads them instead of pulling the device
    # arrays back (format/hostcache.py)
    from . import hostcache

    r_all = (bid // nbc) * np.int64(BLOCK_HEIGHT)
    if transposed:
        r_all = r_all + (intra % 8)
        c_all = (bid % nbc) * np.int64(BLOCK_WIDTH) + intra // 8
    else:
        r_all = r_all + intra // 8
        c_all = (bid % nbc) * np.int64(BLOCK_WIDTH) + (intra % 8)
    hostcache.put(
        m, coo=(r_all, c_all, vals),
        brow=brow, bcol=bcol, bmp_hi=hi, bmp_lo=lo,
        offsets=offsets, values=vals,
    )
    return m


def coo_to_bmsparse(
    rows,
    cols,
    vals,
    shape: tuple[int, int],
    transposed: bool = False,
    compact: bool = True,
    nb_pad: int | None = None,
    backend: str = "device",
) -> BmSparse:
    """Convert COO triplets to BmSparse.

    Args:
      rows, cols: int32 arrays of coordinates (0-based). Duplicate
        coordinates: the HOST backend sums them (scipy/cusp COO assembly
        semantics); the DEVICE backend requires duplicate-free input —
        the same precondition as the reference converter (its
        reduce_by_key would mis-merge them too, ref:
        src/bmSpMatrix.cu:176-216) — because the jitted one-hot
        segment-sum would corrupt the bitmap. Deduplicate (e.g. via
        scipy .sum_duplicates()) before using backend="device".
      vals: value array (any float dtype).
      shape: (num_rows, num_cols).
      transposed: store intra-block column-major (for SpGEMM's B operand).
      compact: if True, sync the block count to host and slice the arrays
        to a bucketed exact size (like the reference's block_num sync). If
        False, stays fully on-device with nnz-sized padding (jit-safe).
      nb_pad: optional explicit padded block-array size (requires >= nb).
      backend: "device" (jitted XLA pipeline — the reference's GPU
        converter analogue) or "host" (vectorized numpy — the reference's
        host converter analogue; requires host arrays, ignores
        compact/nb_pad, produces exact unpadded arrays).
    """
    if backend == "host":
        if nb_pad is not None:
            raise ValueError("nb_pad requires backend='device'")
        return _coo_to_bmsparse_host(rows, cols, vals, shape, transposed)
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)
    vals = jnp.asarray(vals)
    n = int(rows.shape[0])
    num_block_rows = cdiv(shape[0], BLOCK_HEIGHT)

    if n == 0:
        # Degenerate but legal (e.g. an empty shard after partitioning):
        # one padding block, zero values.
        dtype = vals.dtype if jnp.issubdtype(vals.dtype, jnp.floating) else jnp.float32
        return BmSparse(
            brow=jnp.full((1,), num_block_rows, jnp.int32),
            bcol=jnp.zeros((1,), jnp.int32),
            bmp_hi=jnp.zeros((1,), jnp.uint32),
            bmp_lo=jnp.zeros((1,), jnp.uint32),
            offsets=jnp.zeros((1,), jnp.int32),
            values=jnp.zeros((1,), dtype),
            nb=jnp.int32(0),
            num_rows=shape[0], num_cols=shape[1], nnz=0,
            transposed=transposed,
        )

    brow, bcol, hi, lo, offsets, values, nb = _coo_to_bmsparse_core(
        rows, cols, vals, transposed, num_block_rows
    )

    if compact:
        nb_i = int(nb)
        k = nb_pad if nb_pad is not None else min(bucket_size(nb_i), n)
        k = max(k, nb_i)
        if k < n:
            brow, bcol, hi, lo, offsets = (
                a[:k] for a in (brow, bcol, hi, lo, offsets)
            )
    elif nb_pad is not None:
        raise ValueError("nb_pad requires compact=True")

    return BmSparse(
        brow=brow, bcol=bcol, bmp_hi=hi, bmp_lo=lo,
        offsets=offsets, values=values, nb=nb,
        num_rows=shape[0], num_cols=shape[1], nnz=n,
        transposed=transposed,
    )


def bmsparse_to_coo(m: BmSparse):
    """Host-side decompression (rows, cols, values) — see
    BmSparse.generate_coo."""
    return m.generate_coo()


def transpose(m: BmSparse, transposed: bool | None = None) -> BmSparse:
    """A.T as a new BmSparse — the cusp::transpose analogue (the reference
    pulls in cusp/transpose.h; SURVEY.md §2 #13).

    Semantically exact: block keys swap, each 8x8 bitmap is transposed and
    values re-pack in the new bit order. Implemented through the COO
    round-trip (the conversion pipeline re-sorts and re-packs), which also
    keeps it correct for both intra-block storage layouts.

    Args:
      transposed: intra-block storage layout of the RESULT (default: keep
        the input's layout).
    """
    rows, cols, vals = m.generate_coo()
    if transposed is None:
        transposed = m.transposed
    return coo_to_bmsparse(
        cols.astype(np.int32), rows.astype(np.int32),
        vals.astype(np.asarray(m.values).dtype),
        (m.num_cols, m.num_rows), transposed=transposed,
    )


# ---------------------------------------------------------------------------
# CSR — a real implementation of the reference's never-finished CSRMatrix
# stub (ref: include/CSRMatrix.h:13-21) plus the CSR reference ops used as
# the CPU-path oracle (BASELINE config 1).
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed-sparse-row matrix (device arrays, pytree)."""

    indptr: jax.Array   # int32[num_rows + 1]
    indices: jax.Array  # int32[nnz]
    data: jax.Array     # dtype[nnz]
    num_rows: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_cols: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    @classmethod
    def from_scipy(cls, m) -> "CSRMatrix":
        m = m.tocsr()
        return cls(
            indptr=jnp.asarray(m.indptr, jnp.int32),
            indices=jnp.asarray(m.indices, jnp.int32),
            data=jnp.asarray(m.data),
            num_rows=m.shape[0],
            num_cols=m.shape[1],
        )

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (np.asarray(self.data), np.asarray(self.indices),
             np.asarray(self.indptr)),
            shape=self.shape,
        )

    def row_ids(self) -> jax.Array:
        """Expand indptr to one row id per nonzero (device-side)."""
        counts = self.indptr[1:] - self.indptr[:-1]
        return jnp.repeat(
            jnp.arange(self.num_rows, dtype=jnp.int32),
            counts,
            total_repeat_length=self.nnz,
        )


def csr_to_bmsparse(csr: CSRMatrix, transposed: bool = False, **kw) -> BmSparse:
    rows = csr.row_ids()
    return coo_to_bmsparse(
        rows, csr.indices, csr.data, csr.shape, transposed=transposed, **kw
    )


def bmsparse_to_csr(m: BmSparse) -> CSRMatrix:
    r, c, v = m.generate_coo()
    import scipy.sparse as sp

    return CSRMatrix.from_scipy(
        sp.csr_matrix((v, (r, c)), shape=m.shape).astype(np.asarray(m.values).dtype)
    )
