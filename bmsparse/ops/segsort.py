"""On-device segmented sort — the bb_segsort replacement.

The reference vendors bb_segsort (Hou et al., ICS'17;
include/bb_segsort-master/) to sort the SpGEMM task list *within* A-block-row
segments when it exceeds BORDER = 2,730,000 tasks
(ref: src/bmSparse_SPGEMM.cu:53,963-1016); below that it uses a global
thrust::sort. Here neither a size-binned multi-kernel sort nor the
global/segmented distinction is needed: XLA's `lax.sort` is a single fused
bitonic/radix sort, and a segmented sort is just a lexicographic sort with
the segment id as leading key. This both replaces bb_segsort and erases the
BORDER crossover (SURVEY.md §7.3).
"""

from __future__ import annotations

import jax


def segmented_sort(seg_ids: jax.Array, *keys_and_vals: jax.Array, num_keys: int = 1):
    """Sort values within segments.

    Args:
      seg_ids: int array of segment ids (need not be pre-sorted).
      *keys_and_vals: first `num_keys` arrays are sort keys (lexicographic
        after the segment id), the rest are carried values.
      num_keys: number of key operands among keys_and_vals.

    Returns: (seg_ids_sorted, *keys_and_vals_sorted).
    """
    out = jax.lax.sort((seg_ids, *keys_and_vals), num_keys=1 + num_keys)
    return out


def sort_by_key(*operands: jax.Array, num_keys: int = 1):
    """Plain multi-key sort (thrust::sort analogue)."""
    return jax.lax.sort(operands, num_keys=num_keys)
