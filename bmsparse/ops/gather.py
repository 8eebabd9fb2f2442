"""Row-gather helper for the numeric phases.

The CUDA reference leans on per-element shared-memory gathers
(ref: src/bmSparse_SPGEMM.cu:152-162); here every dynamic access is a
row gather of a plan-time index table (ops/plan.py, ops/spgemm.py
_plan_sell_device).
"""

from __future__ import annotations

import jax.numpy as jnp


def gather_rows(table, idx):
    """out[t] = table[idx[t]] with out-of-range indices clamped."""
    return jnp.take(table, jnp.clip(idx, 0, table.shape[0] - 1), axis=0)
