"""The BmSparse container — a JAX restatement of `bmSpMatrix<T>`.

Reference layout (include/bmSpMatrix.h:20-40): four parallel device arrays
``keys: u64``, ``bmps: u64``, ``offsets: u64``, ``values: T`` plus dims.
Here the 64-bit quantities are split into 32-bit words (JAX runs with
64-bit integers disabled by default):

  * ``brow, bcol : int32[nb]``   — block coordinates; together they are the
    reference's ``key = (block_row << 32) | block_col``
    (ref: src/bmSpMatrix.cu:76-83), kept sorted lexicographically by
    (brow, bcol) — plain row-major block order.
  * ``bmp_hi, bmp_lo : uint32[nb]`` — the 8x8 occupancy bitmap
    (see format/bitmap.py for the bit convention).
  * ``offsets : int32[nb]``      — exclusive prefix sum of per-block nnz
    (ref: src/bmSpMatrix.cu:180-194).
  * ``values : dtype[nnz]``      — nonzeros packed block-by-block in
    bitmap-bit order (ref: src/bmSpMatrix.cu:163-172).

Padding convention (jit-specific, no reference analogue): arrays may be
padded past ``nb_valid`` blocks / ``nnz`` values. Padding blocks carry
``bmp == 0`` and clamped offsets; a zero bitmap decompresses to an all-zero
dense block, so padded blocks are identity elements in every kernel — no
masks needed on the compute paths. ``brow``/``bcol`` of padding blocks are
set past the last valid block coordinate so sorted order is preserved.

The container is a registered pytree, so it flows through jit / vmap /
shard_map unchanged.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BLOCK_HEIGHT, BLOCK_WIDTH
from . import bitmap as bm


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BmSparse:
    """Bitmap-sparse matrix in 8x8-block compressed form."""

    brow: jax.Array     # int32[nb_pad]
    bcol: jax.Array     # int32[nb_pad]
    bmp_hi: jax.Array   # uint32[nb_pad]
    bmp_lo: jax.Array   # uint32[nb_pad]
    offsets: jax.Array  # int32[nb_pad]
    values: jax.Array   # dtype[nnz_pad]
    # Number of valid (non-padding) blocks, as a traced scalar so the
    # container stays jit-transparent. Equals nb_pad when unpadded.
    nb: jax.Array       # int32[] — dataclasses field, still a leaf

    # --- static metadata ---
    num_rows: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_cols: int = dataclasses.field(metadata=dict(static=True), default=0)
    nnz: int = dataclasses.field(metadata=dict(static=True), default=0)
    # True when intra-block layout is column-major (the B operand of SpGEMM;
    # ref: src/bmSpMatrix.cu:91-95).
    transposed: bool = dataclasses.field(metadata=dict(static=True), default=False)

    # ------------------------------------------------------------------
    @property
    def nb_pad(self) -> int:
        return self.brow.shape[0]

    @property
    def nnz_pad(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def block_rows(self) -> int:
        """Number of block rows covering the matrix."""
        return cdiv(self.num_rows, BLOCK_HEIGHT)

    @property
    def block_cols(self) -> int:
        return cdiv(self.num_cols, BLOCK_WIDTH)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    # ------------------------------------------------------------------
    def block_nnz(self) -> jax.Array:
        """Per-block nonzero count (popcount of the bitmap)."""
        return bm.popcount(self.bmp_hi, self.bmp_lo)

    def decompress_blocks_flat(self, dtype=None) -> jax.Array:
        """Expand packed values into dense flat tiles: (nb_pad, 64),
        row-major slots (slot = rel_i*8 + rel_j) regardless of storage
        layout.

        The replacement for the reference's in-kernel prefix-popcount
        ``shmem_load`` (ref: src/bmSparse_SPGEMM.cu:152-162): instead of
        decompressing per warp per use, decompress once into dense tiles.
        Zero-bitmap (padding) blocks yield zero tiles. See
        format/blockops.py for the (n, 64) layout.
        """
        from .blockops import storage_to_rowmajor

        bits = bm.expand_bits(self.bmp_hi, self.bmp_lo)        # (nb, 64)
        slot = bm.prefix_popcount(bits)                        # (nb, 64)
        idx = jnp.clip(self.offsets[:, None] + slot, 0, self.nnz_pad - 1)
        vals = jnp.take(self.values, idx, axis=0)              # (nb, 64)
        dense = jnp.where(bits > 0, vals, jnp.zeros((), self.values.dtype))
        dense = storage_to_rowmajor(dense, self.transposed)
        if dtype is not None:
            dense = dense.astype(dtype)
        return dense

    def decompress_blocks(self, dtype=None) -> jax.Array:
        """(nb_pad, 8, 8) dense tiles ([rel_i, rel_j]); prefer
        `decompress_blocks_flat` on hot paths (layout)."""
        return self.decompress_blocks_flat(dtype).reshape(self.nb_pad, 8, 8)

    def valid_mask(self) -> jax.Array:
        return jnp.arange(self.nb_pad, dtype=jnp.int32) < self.nb

    # ------------------------------------------------------------------
    def pad_to(self, nb_pad: int, nnz_pad: int | None = None) -> "BmSparse":
        """Grow (never shrink) padding. Padding blocks get bmp=0 and block
        coordinates past the matrix so sorted order is kept."""
        if nb_pad < self.nb_pad:
            raise ValueError(f"cannot shrink nb_pad {self.nb_pad} -> {nb_pad}")
        extra = nb_pad - self.nb_pad
        sentinel_row = jnp.int32(self.block_rows)  # one past last valid brow
        brow = jnp.concatenate([self.brow, jnp.full((extra,), sentinel_row)])
        bcol = jnp.concatenate([self.bcol, jnp.zeros((extra,), jnp.int32)])
        zeros = jnp.zeros((extra,), jnp.uint32)
        off_pad = jnp.full((extra,), max(self.nnz_pad - 1, 0), jnp.int32)
        values = self.values
        if nnz_pad is not None and nnz_pad > self.nnz_pad:
            values = jnp.concatenate(
                [values, jnp.zeros((nnz_pad - self.nnz_pad,), values.dtype)]
            )
        return dataclasses.replace(
            self,
            brow=brow,
            bcol=bcol,
            bmp_hi=jnp.concatenate([self.bmp_hi, zeros]),
            bmp_lo=jnp.concatenate([self.bmp_lo, zeros]),
            offsets=jnp.concatenate([self.offsets, off_pad]),
            values=values,
        )

    def astype(self, dtype) -> "BmSparse":
        return dataclasses.replace(self, values=self.values.astype(dtype))

    # ------------------------------------------------------------------
    def generate_coo(
        self, order: str = "rowcol"
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decompress to host COO (rows, cols, values) — the verification
        path of the reference (`generate_coo`, ref: src/bmSpMatrix.cu:320-363).

        Returns arrays of length == true nnz; values as float64.
        order: "rowcol" sorts by (row, col) — the reference's contract
        (ref: src/bmSpMatrix.cu:355-356); "any" skips the sort for
        order-independent consumers (plan building, scipy interop) —
        a 35M-nnz lexsort costs ~10 s the consumer doesn't need.

        The triplets come from the host-array cache when a host-side
        producer (numpy converter, npz loader, a previous pull) has them
        (see format/hostcache.py).
        """
        from . import hostcache

        coo = hostcache.get(self, "coo")
        if coo is None:
            brow, bcol, hi, lo, offsets, values = (
                hostcache.fetch_format_arrays(self)
            )
            bmp = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(
                np.uint64
            )
            addr = np.arange(64, dtype=np.uint64)
            # narrow dtypes: the (nb, 64) intermediates are the dominant
            # host cost at 35M+ nnz
            bits = (
                (bmp[:, None] >> (np.uint64(63) - addr)) & np.uint64(1)
            ).astype(np.uint8)
            slot = (np.cumsum(bits, axis=1, dtype=np.int16)
                    - bits).astype(np.int32)
            if self.transposed:
                rel_j, rel_i = np.divmod(np.arange(64, dtype=np.int32), 8)
            else:
                rel_i, rel_j = np.divmod(np.arange(64, dtype=np.int32), 8)
            kk, aa = np.nonzero(bits)
            rows = brow[kk].astype(np.int64) * BLOCK_HEIGHT + rel_i[aa]
            cols = bcol[kk].astype(np.int64) * BLOCK_WIDTH + rel_j[aa]
            vals = values[offsets[kk] + slot[kk, aa]]
            coo = (rows, cols, vals)
            hostcache.put(self, coo=coo)
        rows, cols, vals = coo
        if order == "rowcol":
            o = np.lexsort((cols, rows))
            rows, cols, vals = rows[o], cols[o], vals[o]
        return rows, cols, vals.astype(np.float64)

    def to_scipy(self):
        """Dense oracle interop: return a scipy.sparse.coo_matrix."""
        import scipy.sparse as sp

        r, c, v = self.generate_coo(order="any")
        return sp.coo_matrix((v, (r, c)), shape=self.shape)

    # ------------------------------------------------------------------
    def compare(self, oracle, verbose: bool = False) -> float:
        """Mean relative error against an oracle matrix — the reference's
        `compare` (ref: src/bmSpMatrix.cu:381-432). See oracle/compare.py."""
        from ..oracle.compare import mean_relative_error

        return mean_relative_error(self, oracle, verbose=verbose)

    def __repr__(self) -> str:  # keep tracers printable
        try:
            nb = int(self.nb)
        except Exception:
            nb = -1
        return (
            f"BmSparse(shape={self.shape}, nnz={self.nnz}, blocks={nb}"
            f"/{self.nb_pad}, dtype={self.values.dtype}, "
            f"transposed={self.transposed})"
        )

    def print_matrix(self, stream=None, max_entries: int = 200) -> None:
        """Human-readable COO dump — the cusp::print analogue (the
        reference pulls in cusp/print.h; SURVEY.md §2 #13)."""
        import sys

        out = stream or sys.stdout
        r, c, v = self.generate_coo()
        out.write(
            f"sparse matrix <{self.num_rows}, {self.num_cols}> "
            f"with {len(r)} entries\n"
        )
        for i in range(min(len(r), max_entries)):
            out.write(f"  {int(r[i])} {int(c[i])} {v[i]}\n")
        if len(r) > max_entries:
            out.write(f"  ... ({len(r) - max_entries} more)\n")
