"""Sparse-structure generators and the benchmark matrix suite.

The reference benchmarks against a SuiteSparse ssget mirror
(ref: spgemm_run_batch.sh:1-16) which is not downloadable in this
environment; these generators reproduce the three structural families
that dominate that collection so the planner's tier choices are
exercised on non-synthetic-looking structure:

  * fem2d     — P1 finite-element stiffness pattern on a structured
                triangulated grid: 7-point 2-D stencil (offsets 0, ±1,
                ±g, ±(g+1)); symmetric positive-diagonal values. The
                classic "banded but 2-D" matrix (DIA-tier friendly, with
                far diagonals).
  * roadnet   — planar-ish road network: low bounded degree, strong
                locality with occasional longer links (highways);
                near-symmetric. Exercises the SELL tier with small K and
                scattered single-nnz blocks.
  * webgraph  — power-law in-degree link graph (Zipf-distributed hub
                columns, locality-free). The adversarial skewed case for
                sigma-SELL chunk depths.

All return (rows, cols, vals) int32/int32/float32 COO, sorted row-major,
no duplicates. `suite_matrix(name)` builds the benchmark's named
matrices (bench.py, chip_smoke.py) from these generators and fixed seeds.
"""

from __future__ import annotations

import numpy as np


def _dedup(rows, cols, n):
    key = np.unique(rows.astype(np.int64) * n + cols.astype(np.int64))
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def fem2d(grid: int, seed: int = 0):
    """P1 stiffness pattern on a grid x grid triangulated mesh
    (n = grid**2 rows)."""
    n = grid * grid
    rng = np.random.default_rng(seed)
    node = np.arange(n, dtype=np.int64)
    x = node % grid
    y = node // grid
    nbr_offs = [0, 1, -1, grid, -grid, grid + 1, -(grid + 1)]
    rows_l, cols_l = [], []
    for o in nbr_offs:
        c = node + o
        ok = (c >= 0) & (c < n)
        # forbid wrap-around across grid rows for the ±1 / ±(g+1) stencils
        if o in (1, grid + 1):
            ok &= x < grid - 1
        if o in (-1, -(grid + 1)):
            ok &= x > 0
        rows_l.append(node[ok])
        cols_l.append(c[ok])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    rows, cols = _dedup(rows, cols, n)
    # stiffness-like values: negative off-diagonal, dominant diagonal
    vals = np.where(
        rows == cols, 6.0 + rng.random(rows.shape[0]),
        -(0.5 + rng.random(rows.shape[0])),
    ).astype(np.float32)
    return rows, cols, vals, (n, n)


def roadnet(n: int, seed: int = 0):
    """Planar-ish road network: each node links to 2-4 nearby nodes plus
    ~0.5% longer-range 'highway' links; symmetrized."""
    rng = np.random.default_rng(seed)
    node = np.arange(n, dtype=np.int64)
    deg = rng.integers(2, 5, n)
    src = np.repeat(node, deg)
    # local links: offsets geometric-ish within a +-64 window
    off = (rng.geometric(0.08, src.shape[0]) * rng.choice(
        [-1, 1], src.shape[0]))
    dst = np.clip(src + off, 0, n - 1)
    # highways
    nh = max(n // 200, 1)
    hs = rng.integers(0, n, nh)
    hd = np.clip(hs + rng.integers(-n // 8, n // 8, nh), 0, n - 1)
    rows = np.concatenate([src, dst, hs, hd])
    cols = np.concatenate([dst, src, hd, hs])
    keep = rows != cols
    rows, cols = _dedup(rows[keep], cols[keep], n)
    vals = rng.random(rows.shape[0]).astype(np.float32) + 0.1
    return rows, cols, vals.astype(np.float32), (n, n)


def webgraph(n: int, avg_deg: int = 8, seed: int = 0):
    """Power-law link graph: out-edges from every page, targets drawn
    Zipf-like so a few hub columns are extremely dense."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    src = rng.integers(0, n, m)
    # Zipf-ish targets via inverse-CDF of a truncated power law
    u = rng.random(m)
    dst = np.minimum((u ** 3.0) * n, n - 1).astype(np.int64)
    # permute hub ids so the dense columns are scattered, not clustered
    perm = rng.permutation(n)
    dst = perm[dst]
    keep = src != dst
    rows, cols = _dedup(src[keep], dst[keep], n)
    vals = rng.random(rows.shape[0]).astype(np.float32) + 0.01
    return rows, cols, vals.astype(np.float32), (n, n)


def random_uniform(n, density, seed=0):
    """Uniform random n x n pattern (the adversarial single-nnz-block
    case)."""
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    flat = rng.choice(n * n, size=nnz, replace=False)
    rows, cols = np.divmod(flat, n)
    vals = rng.standard_normal(nnz).astype(np.float32)
    order = np.lexsort((cols, rows))
    return (rows[order].astype(np.int32), cols[order].astype(np.int32),
            vals[order], (n, n))


def banded(n, band, seed=0):
    """`band` random offsets in [-band/2, band/2] per row (duplicates
    merged): a band that is partly filled."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), band)
    offs = rng.integers(-band // 2, band // 2 + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def stencil(n, half_width, seed=0):
    """Dense band (every diagonal fully populated) — the classic
    PDE-stencil family; diagonals have ~100% fill so the DIA tier reads
    no padding."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-half_width, half_width + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def blockdense(n, num_blocks, seed=0):
    """Fully-dense 8x8 blocks scattered uniformly — the format's ideal
    case."""
    rng = np.random.default_rng(seed)
    nb_side = n // 8
    flat = rng.choice(nb_side * nb_side, size=num_blocks, replace=False)
    br, bc = np.divmod(flat, nb_side)
    ri, rj = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    rows = (br[:, None] * 8 + ri.reshape(-1)[None, :]).reshape(-1)
    cols = (bc[:, None] * 8 + rj.reshape(-1)[None, :]).reshape(-1)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    order = np.lexsort((cols, rows))
    return (rows[order].astype(np.int32), cols[order].astype(np.int32),
            vals[order], (n, n))


# The benchmark suite: name -> COO generator with its fixed seed. The
# 1M-2M-row members hold 4-36M nonzeros (SuiteSparse scale); the smaller
# ones fit the GPU's L2 cache.
SUITE = {
    "band256k": lambda: banded(262144, 16, seed=2),
    "blockdense64k": lambda: blockdense(65536, 40960, seed=3),
    "rand64k": lambda: random_uniform(65536, 3e-4, seed=1),
    "band2M": lambda: banded(2_097_152, 16, seed=4),
    # wider band -> ~4M tasks, past the reference's 2.73M bb_segsort
    # crossover (ref: src/bmSparse_SPGEMM.cu:53)
    "border4M": lambda: banded(2_097_152, 24, seed=10),
    "stencil2M": lambda: stencil(2_097_152, 8, seed=6),
    "blockdense1M": lambda: blockdense(1_048_576, 327_680, seed=5),
    "fem1M": lambda: fem2d(1024, seed=7),
    "road1M": lambda: roadnet(1_048_576, seed=8),
    "web256k": lambda: webgraph(262_144, avg_deg=8, seed=9),
}


def suite_matrix(name: str, transposed: bool = False):
    """The suite matrix `name` as a BmSparse (host-side conversion)."""
    from ..format.convert import coo_to_bmsparse

    rows, cols, vals, shape = SUITE[name]()
    return coo_to_bmsparse(rows, cols, vals, shape, transposed=transposed,
                           backend="host")
