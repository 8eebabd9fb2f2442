"""Device-time measurement by dependent chains.

`time_chain` runs `iters` data-dependent executions of a step inside ONE
jitted fori_loop (a single dispatch), waits for the result with
block_until_ready, and differences two trip counts: the per-iteration
time then excludes dispatch, launch and synchronisation overheads, which
matters for sub-millisecond steps. The data dependence between
iterations keeps XLA from hoisting or overlapping them.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def time_chain(step_fn, x0, iters: int = 30, reps: int = 3, args=()) -> float:
    """Median per-iteration seconds of `x = step_fn(x, *args)` chained in
    one dispatch. `step_fn` must be shape-preserving and keep a data
    dependence between iterations.

    Methodology: ONE jitted fori_loop with a *dynamic* trip count; the
    per-iteration time is (t(n_hi) - t(n_lo)) / (n_hi - n_lo), which
    cancels the fixed per-call overheads. The dynamic trip count also
    stops XLA from unrolling/specializing across iterations.

    Pass large arrays via `args` — NOT via closure: closed-over device
    arrays are serialized into the program as constants."""

    def chained_fn(a, n, *rest):
        return jax.lax.fori_loop(
            0, n, lambda i, s: step_fn(s, *rest), a, unroll=False
        )

    chained = jax.jit(chained_fn)

    def run(n):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(x0, jnp.int32(n), *args))
        return time.perf_counter() - t0

    run(1)  # compile + warm
    # Calibrate the trip count so the chain runs ~150 ms on device, long
    # against the host-side jitter of one call.
    est = max((run(64) - run(2)) / 62, 1e-7)
    n = int(min(max(0.15 / est, 64), 100_000))
    deltas = []
    for _ in range(reps):
        t_lo = run(2)
        t_hi = run(2 + n)
        deltas.append((t_hi - t_lo) / n)
    deltas.sort()
    return max(deltas[len(deltas) // 2], 1e-9)
