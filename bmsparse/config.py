"""Global configuration for the bmSparse framework.

Mirrors the reference's three configuration tiers
(ref: src/bmSparse_SPGEMM.cu:35-53 compile-time #defines, Makefile:9-36
variables, and positional argv flags) as:

  1. module constants (block geometry — fixed by the format),
  2. environment variables / `Config` overrides,
  3. CLI flags (see bmsparse/cli/).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

# ---------------------------------------------------------------------------
# Format geometry (ref: include/bmSpMatrix.h:15-17). These are part of the
# on-array format definition and must not change.
# ---------------------------------------------------------------------------
BLOCK_WIDTH = 8
BLOCK_HEIGHT = 8
BLOCK_SIZE = BLOCK_WIDTH * BLOCK_HEIGHT  # 64 — bits in one occupancy bitmap


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "")


@dataclasses.dataclass
class Config:
    """Tunables for kernels and orchestration.

    Unlike the reference's compile-time constants
    (TASKS_PER_WARP/WARPS_PER_BLOCK/TASK_BUFFER, src/bmSparse_SPGEMM.cu:43-49)
    these are runtime-selectable; they only affect performance, never
    results.
    """

    # Shape-bucketing granularity for host-orchestrated (non-padded) paths:
    # dynamic sizes are rounded up to the next multiple of 2**bucket_bits of
    # their leading power of two, bounding jit recompiles. 0 = exact shapes.
    bucket_shapes: bool = _env_bool("BMSP_BUCKET_SHAPES", True)
    # Default SpGEMM numeric kernel ("auto" = "sell" | "xla" | "pallas").
    # The reference's analogous switch is tc_version (default 5 = the
    # scalar, non-tensor-core variant; src/bmSparse_SPGEMM.cu:1230).
    spgemm_impl: str = os.environ.get("BMSP_SPGEMM_IMPL", "auto")
    # SpGEMM compress stage: "scatter" (row scatter-add) | "fold"
    # (gather-fold contributor table, still subject to its validity
    # bounds) | "auto" = scatter.
    spgemm_compress: str = os.environ.get("BMSP_SPGEMM_COMPRESS", "auto")
    # Verbose per-phase timing (ref: VERBOSE flag, src/bmSparse_SPGEMM.cu:835).
    verbose: bool = _env_bool("BMSP_VERBOSE", False)


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_size(n: int, minimum: int = 16) -> int:
    """Round a dynamic size up to a shape bucket to bound recompilation.

    Buckets are {m, 1.25m, 1.5m, 1.75m} for each power of two m — at most
    4 buckets per octave, ≤ 25% padding overhead.
    """
    if n <= minimum:
        return minimum
    if not _config.bucket_shapes:
        return n
    m = 1 << (n - 1).bit_length() - 1  # largest pow2 <= n-1... floor pow2
    while m < n:
        step = max(m // 4, 1)
        for k in range(1, 5):
            if m + k * step >= n:
                return m + k * step
        m *= 2
    return m


# ---------------------------------------------------------------------------
# Persistent compilation cache
# ---------------------------------------------------------------------------
# Fixed in-checkout location (listed in .gitignore): the cache key includes
# the path, so a directory that moves never hits.
_CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def compile_cache_dir() -> str | None:
    """The persistent compile cache directory in effect: None when
    BMSP_NO_COMPILE_CACHE is set, JAX_COMPILATION_CACHE_DIR when set
    (JAX reads it itself), else <checkout>/.jax_cache."""
    if os.environ.get("BMSP_NO_COMPILE_CACHE"):
        return None
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(_CHECKOUT_CACHE))


def enable_compile_cache() -> str | None:
    """Point JAX at compile_cache_dir() (bench.py, the CLIs and
    chip_smoke.py call this before their first compile). Returns the
    directory, or None when disabled."""
    path = compile_cache_dir()
    if path is None or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
