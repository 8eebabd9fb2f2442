"""Conjugate-gradient solve with bmSparse SpMV — the canonical
iterative-solver workload the SpMV path is designed for (the plan's tiers
stay device-resident across iterations, so each step costs one
HBM pass over the nonzero values).

    python examples/cg.py [n] [iters]

Builds an SPD 1-D Laplacian-like stencil system A x = b, runs jit-compiled
CG entirely on device, and reports the residual and iteration throughput.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_spd_stencil(n: int):
    """Tridiagonal SPD system (2nd-order Laplacian + diagonal shift)."""
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([
        np.full(n, 2.5, np.float32),
        np.full(n - 1, -1.0, np.float32),
        np.full(n - 1, -1.0, np.float32),
    ])
    return rows.astype(np.int32), cols.astype(np.int32), vals


def cg(p, b, iters: int):
    """jit-compiled fixed-iteration CG on a Prepared bmSparse matrix."""
    import jax
    import jax.numpy as jnp

    from bmsparse.ops.spmv import spmv

    def step(state, _):
        x, r, pv, rs = state
        ap = spmv(p, pv)
        # guard the 0/0 once fully converged (fixed-iteration scan)
        tiny = jnp.asarray(1e-30, rs.dtype)
        alpha = rs / jnp.maximum(jnp.vdot(pv, ap), tiny)
        x = x + alpha * pv
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        pv = r + (rs_new / jnp.maximum(rs, tiny)) * pv
        return (x, r, pv, rs_new), rs_new

    @jax.jit
    def run(b):
        x0 = jnp.zeros_like(b)
        r0 = b
        state = (x0, r0, r0, jnp.vdot(r0, r0))
        state, hist = jax.lax.scan(step, state, None, length=iters)
        return state[0], hist

    return run(b)


def main():
    import jax.numpy as jnp

    from bmsparse import coo_to_bmsparse
    from bmsparse.ops.plan import prepare

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 262144
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 100

    rows, cols, vals = build_spd_stencil(n)
    a = coo_to_bmsparse(rows, cols, vals, (n, n), backend="host")
    p = prepare(a)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    x, hist = cg(p, b, iters)          # compile + run
    x.block_until_ready()
    t0 = time.perf_counter()
    x, hist = cg(p, b, iters)
    x.block_until_ready()
    dt = time.perf_counter() - t0

    res = np.asarray(hist[-1]) ** 0.5
    print(f"n={n} iters={iters}: |r| = {res:.3e}, wall {dt:.3f}s "
          f"({dt / iters * 1e6:.1f} us/iteration incl. dispatch overhead; "
          "per-iteration device time is the SpMV bench number)")


if __name__ == "__main__":
    main()
