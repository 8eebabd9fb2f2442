"""SpGEMM CLI driver — the reference benchmark binary
(`bmsparse_spgemm_float folder A_name B_name [segmented] [tc_version]
[verbose]`, ref main: src/bmSparse_SPGEMM.cu:1226-1288) as a real flag
parser with the same positional surface and output lines.

Behavior parity:
  * loads A untransposed and B transposed (ref :1261-1262); inputs cast to
    --dtype (default bfloat16, standing in for the reference's half),
    output C is float32 (ref OUTPUT_TYPE, :51);
  * prints parse time, execution time, C block count and C nnz in the
    reference's format (ref :1282-1285);
  * `segmented`/`tc_version` are accepted for CLI compatibility; a
    single lax.sort strategy replaces the thrust/bb_segsort split and the
    numeric variant is chosen via --impl (the analogue of tc_version).

Usage:
  python -m bmsparse.cli.spgemm data/real A_matrix B_matrix [1] [5] [1]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bmsparse-spgemm", description=__doc__.splitlines()[0]
    )
    p.add_argument("folder", help="directory containing the .mtx files")
    p.add_argument("a_name", help="A matrix name (without .mtx)")
    p.add_argument("b_name", help="B matrix name (without .mtx)")
    p.add_argument("segmented", nargs="?", type=int, default=0,
                   help="compat flag (reference sort mode; ignored)")
    p.add_argument("tc_version", nargs="?", type=int, default=5,
                   help="compat flag (reference kernel variant)")
    p.add_argument("verbose", nargs="?", type=int, default=0,
                   help="1 = per-phase timings (reference VERBOSE)")
    p.add_argument("--impl", default=None,
                   choices=["xla", "sell", "pallas"],
                   help="numeric kernel: 'sell'/'pallas' run the "
                        "task-SELL fast path (XLA / fused Triton kernel, "
                        "GPU only), 'xla' the jit-safe chunked variant. "
                        "Default maps the positional tc_version like the "
                        "reference: 1-4 (tensor-core variants) -> "
                        "'pallas', 5 (scalar) -> 'auto'")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "float64"],
                   help="input value dtype (reference uses half)")
    p.add_argument("--check", action="store_true",
                   help="verify against the scipy oracle (compare())")
    from ._platform import add_platform_arg

    add_platform_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ._platform import apply_platform

    apply_platform(args)
    import jax.numpy as jnp

    from .. import mmread_bmsparse, set_config

    if args.verbose:
        set_config(verbose=True)
    dtype = jnp.dtype(args.dtype)

    a_path = os.path.join(args.folder, args.a_name)
    b_path = os.path.join(args.folder, args.b_name)

    t0 = time.perf_counter()
    a = mmread_bmsparse(a_path, dtype=dtype, transposed=False)
    b = mmread_bmsparse(b_path, dtype=dtype, transposed=True)
    parse_us = (time.perf_counter() - t0) * 1e6
    print(f"Parsing data: {parse_us:.0f}")

    from ..ops.spgemm import spgemm
    from ..utils.timing import sync

    # warm-up compile (the reference warms the CUDA context via cudaFree(0),
    # ref :1233; here the analogous one-time cost is jit compilation)
    impl = args.impl or (
        "pallas" if args.tc_version in (1, 2, 3, 4) else "auto"
    )
    c = sync(spgemm(a, b, impl=impl, verbose=False))

    t0 = time.perf_counter()
    c = sync(spgemm(a, b, impl=impl, verbose=bool(args.verbose)))
    exec_us = (time.perf_counter() - t0) * 1e6
    print(f"bmSparse execution: {exec_us:.0f}")
    print(f"C blocks: {int(c.nb)}")
    print(f"C nnz: {c.nnz}")

    if args.check:
        from ..oracle.scipy_oracle import oracle_spgemm

        # compare() prints "Final: <mean rel err>" (reference semantics)
        c.compare(oracle_spgemm(a, b), verbose=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
