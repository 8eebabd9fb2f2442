"""SpMV CLI driver — the reference benchmark binary
(`bmsparse_spmv_float folder A_name [batched]`, ref main:
src/bmSparse_SPMV.cu:232-312) as a real flag parser with the same
positional surface and output lines.

Behavior parity (intended semantics, with the reference's latent traps
fixed — SURVEY.md §5):
  * v initialized to all-ones (ref :279-281);
  * prints parse and execution timings (ref :262-306);
  * the reference loads the matrix twice (once as unused half, ref :257)
    and greets non-square matrices with a num_cols-sized grid (ref
    :217,220) — we load once and size by num_rows;
  * `batched` is accepted for compatibility (the reference's
    spmv_kernel_new variant); the tiered execution plan supersedes it.

Usage:
  python -m bmsparse.cli.spmv data/real A_matrix [1]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bmsparse-spmv", description=__doc__.splitlines()[0]
    )
    p.add_argument("folder", help="directory containing the .mtx file")
    p.add_argument("a_name", help="A matrix name (without .mtx)")
    p.add_argument("batched", nargs="?", type=int, default=0,
                   help="compat flag (reference kernel variant)")
    p.add_argument("--dtype", default="float32",
                   choices=["bfloat16", "float32", "float64"],
                   help="value dtype (reference SpMV driver uses float)")
    p.add_argument("--iters", type=int, default=10,
                   help="timed repetitions (median reported)")
    p.add_argument("--check", action="store_true",
                   help="verify against the scipy oracle")
    from ._platform import add_platform_arg

    add_platform_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ._platform import apply_platform

    apply_platform(args)
    import jax.numpy as jnp

    from .. import mmread_bmsparse
    from ..ops.plan import prepare
    from ..ops.spmv import spmv
    from ..utils.timing import time_op

    dtype = jnp.dtype(args.dtype)
    a_path = os.path.join(args.folder, args.a_name)

    t0 = time.perf_counter()
    a = mmread_bmsparse(a_path, dtype=dtype)
    parse_us = (time.perf_counter() - t0) * 1e6
    print(f"Parsing data: {parse_us:.0f}")

    t0 = time.perf_counter()
    p = prepare(a)
    prep_us = (time.perf_counter() - t0) * 1e6
    print(f"Execution plan: {prep_us:.0f}")

    v = jnp.ones((a.num_cols,), dtype)  # ref fills v with 1s (:279-281)
    t_med, u = time_op(
        lambda: spmv(p, v), iters=max(args.iters, 1)
    )
    print(f"bmSparse SpMV execution: {t_med*1e6:.0f}")

    if args.check:
        ref = np.asarray(a.to_scipy() @ np.ones(a.num_cols))
        err = float(np.max(np.abs(np.asarray(u, np.float64) - ref))
                    / max(np.max(np.abs(ref)), 1e-30))
        print(f"Final: {err}")
        return 0 if err < 1e-2 else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
