"""Speed-of-light models for the bmSparse kernels.

The reference publishes no numbers (BASELINE.md), so the self-measured
baseline is the fraction of the memory-bandwidth roofline achieved. SpMV
at realistic sparsities is memory-bound: the model charges the minimum
traffic the format requires.
"""

from __future__ import annotations

import jax

# Peak device-memory bandwidth, GB/s, keyed by the device_kind the card
# reports. NVIDIA H100 SXM5 80 GB: 3.35 TB/s (NVIDIA H100 Tensor Core GPU
# data sheet). A device not in the table is an error, not a default.
_MEM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def device_hbm_gbps(device=None) -> float:
    """Published peak memory bandwidth (GB/s) of `device` (default: the
    first JAX device). Raises ValueError for a device kind the table does
    not know."""
    d = device or jax.devices()[0]
    kind = getattr(d, "device_kind", str(d))
    try:
        return _MEM_GBPS[kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {kind!r}; "
            f"known: {sorted(_MEM_GBPS)}") from None


def spmv_min_bytes(nnz: int, nb: int, num_rows: int, num_cols: int,
                   value_bytes: int = 4) -> int:
    """Minimum memory traffic for one SpMV pass — the format- and
    implementation-independent speed of light: every nonzero value read
    once, the output vector written once.

    The output write is charged because u must leave the chip every call
    (no consumer can be assumed fused). The INPUT vector v and the
    structure metadata stay uncharged: v may stay cache-resident across
    iterative-solver calls and an ideal plan (the DIA tier) encodes
    structure statically — charging either would let implementations
    exceed 100% of "roofline"."""
    return nnz * value_bytes + num_rows * value_bytes


def spmv_min_bytes_values_only(nnz: int, value_bytes: int = 4) -> int:
    """The values-only floor (see spmv_min_bytes notes)."""
    return nnz * value_bytes


def spgemm_min_bytes(
    nnz_a: int, nb_a: int, nnz_b: int, nb_b: int,
    num_tasks: int, nnz_c: int, nb_c: int, value_bytes: int = 4
) -> int:
    """Minimum traffic for the numeric SpGEMM phase: each task reads two
    blocks (values + bitmap metadata, charged once per task since gather
    locality is data-dependent), C written once."""
    per_block_meta = 8 + 4 + 4
    avg_a = max(nnz_a / max(nb_a, 1), 1.0)
    avg_b = max(nnz_b / max(nb_b, 1), 1.0)
    task_bytes = num_tasks * (
        (avg_a + avg_b) * value_bytes + 2 * per_block_meta + 8
    )
    return int(task_bytes + nnz_c * 4 + nb_c * per_block_meta)


def roofline_nnz_per_s(min_bytes: int, nnz: int, bw_gbps: float) -> float:
    secs = min_bytes / (bw_gbps * 1e9)
    return nnz / secs
