#!/usr/bin/env python
"""Generate the round-4 benchmark corpus as MatrixMarket files.

The reference sweeps SuiteSparse matrices fetched via an ssget mirror
(ref: spgemm_run_batch.sh:1-2, spmv_run_batch.sh:1-2) — unavailable in
this environment (zero egress), so the corpus is generated from the
same structural families at SuiteSparse-like scales and written as
standard .mtx coordinate files that the CLI drivers read exactly like
the reference binaries read theirs.

Usage:  python tools/make_corpus.py [outdir]     (default scratch/corpus)

Writes one .mtx per matrix plus two list files (lista_spmv.txt,
lista_spgemm.txt — the analogue of the reference's lista9.txt).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bmsparse.utils import testmats as tm  # noqa: E402


def make_banded(n, band, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), band)
    offs = rng.integers(-band // 2, band // 2 + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def make_stencil(n, half_width, seed=0):
    rng = np.random.default_rng(seed)
    offs = np.arange(-half_width, half_width + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def make_blockdense(n, num_blocks, seed=0):
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


# name -> (generator, in_spmv_list, in_spgemm_list)
CORPUS = {
    "fem_grid256": (lambda: tm.fem2d(256, seed=7), True, True),
    "fem_grid512": (lambda: tm.fem2d(512, seed=7), True, False),
    "road_262k": (lambda: tm.roadnet(262_144, seed=8), True, False),
    "web_65k": (lambda: tm.webgraph(65_536, avg_deg=8, seed=9), True, True),
    "band_65k": (lambda: make_banded(65_536, 16, seed=2), True, True),
    "stencil_131k": (lambda: make_stencil(131_072, 8, seed=6), True, False),
    "blockdense_32k": (lambda: make_blockdense(32_768, 5_120, seed=3),
                       True, True),
}


def write_mtx(path: str, rows, cols, vals, shape) -> None:
    """Plain coordinate-format writer (mmwrite's savetxt path is ~10x
    slower at millions of entries)."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"% generated by tools/make_corpus.py\n")
        f.write(f"{shape[0]} {shape[1]} {len(rows)}\n")
        buf = []
        for i in range(0, len(rows), 200_000):
            r = rows[i:i + 200_000] + 1
            c = cols[i:i + 200_000] + 1
            v = vals[i:i + 200_000]
            buf.append("\n".join(
                f"{a} {b} {x:.7g}" for a, b, x in zip(r, c, v)))
        f.write("\n".join(buf))
        f.write("\n")


def main() -> int:
    outdir = sys.argv[1] if len(sys.argv) > 1 else "scratch/corpus"
    os.makedirs(outdir, exist_ok=True)
    spmv_list, spgemm_list = [], []
    for name, (gen, in_spmv, in_spgemm) in CORPUS.items():
        path = os.path.join(outdir, f"{name}.mtx")
        if not os.path.exists(path):
            rows, cols, vals, shape = gen()
            write_mtx(path, rows, cols, vals, shape)
            print(f"{name}: {shape[0]}x{shape[1]} nnz={len(rows)} -> {path}")
        else:
            print(f"{name}: exists")
        if in_spmv:
            spmv_list.append(name)
        if in_spgemm:
            spgemm_list.append(name)
    # the in-repo reference sample joins both sweeps (ref data/real)
    import shutil

    shutil.copy("data/real/A_matrix.mtx", os.path.join(outdir, "Ragusa16.mtx"))
    spmv_list.append("Ragusa16")
    spgemm_list.append("Ragusa16")
    for fname, names in (("lista_spmv.txt", spmv_list),
                         ("lista_spgemm.txt", spgemm_list)):
        with open(os.path.join(outdir, fname), "w") as f:
            f.write("\n".join(names) + "\n")
    print("lists:", spmv_list, spgemm_list)
    return 0


if __name__ == "__main__":
    sys.exit(main())
