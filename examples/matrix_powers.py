"""Iterated sparse products with the structure-cached SpGEMM path.

Markov-chain mixing / graph multi-hop counting style workload: compute
u_k = A^k v by alternating cached products and SpMV. The structure of
A @ A is planned ONCE (`prepare_product`); re-multiplies after value
updates (e.g. reweighted graphs) run the device-only numeric path with
zero host syncs — the capability the reference lacks entirely (it re-runs
its full pipeline per multiply, ref: src/bmSparse_SPGEMM.cu:827).

    python examples/matrix_powers.py [n] [band]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(n: int = 65536, band: int = 8) -> int:
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from bmsparse import coo_to_bmsparse, prepare_product
    from bmsparse.ops.plan import prepare
    from bmsparse.ops.spmv import spmv

    rng = np.random.default_rng(0)
    offs = np.arange(-band // 2, band // 2 + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = (rng.random(rows.shape[0]).astype(np.float32) + 0.1)
    a = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                        vals, (n, n), backend="host")
    # same matrix, stored in the transposed intra-block layout SpGEMM's
    # B operand uses (ref: src/bmSparse_SPGEMM.cu:1262)
    bt = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                         vals, (n, n), transposed=True, backend="host")

    t0 = time.perf_counter()
    pp = prepare_product(a, bt)       # symbolic + numeric plan, once
    t_plan = time.perf_counter() - t0
    a2 = pp()                          # C = A @ A (one fused dispatch)
    jax.block_until_ready(a2.values)

    t0 = time.perf_counter()
    a2 = pp()                          # re-multiply: numeric only
    jax.block_until_ready(a2.values)
    t_mul = time.perf_counter() - t0

    # u = A^4 v via (A^2) applied twice
    p2 = prepare(a2)
    v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    u = spmv(p2, spmv(p2, v))
    jax.block_until_ready(u)

    s = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    ref = (s @ s) @ ((s @ s) @ np.asarray(v))
    err = float(np.max(np.abs(np.asarray(u, np.float64) - ref))
                / np.max(np.abs(ref)))
    print(f"n={n} nnz={a.nnz}  A^2 nnz={a2.nnz}")
    print(f"plan (once): {t_plan*1e3:.1f} ms;  cached multiply: "
          f"{t_mul*1e3:.1f} ms")
    print(f"A^4 v rel err vs scipy: {err:.2e}")
    return 0 if err < 1e-4 else 1


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    band = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    sys.exit(main(n, band))
