"""Batch benchmark harness — the reference's spgemm_run_batch.sh /
spmv_run_batch.sh (loop over a matrix list file, append stdout to an
output file; ref: spgemm_run_batch.sh:9-16) as one driver.

Usage:
  python -m bmsparse.cli.batch spgemm matrices_dir list.txt [out.txt]
  python -m bmsparse.cli.batch spmv   matrices_dir list.txt [out.txt]

The list file holds one matrix name per line (without .mtx), like the
reference's `lista9.txt`. SpGEMM runs A·A (the reference passes the same
matrix twice, ref: spgemm_run_batch.sh:15). Per-matrix failures are
recorded and the sweep continues.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bmsparse-batch")
    p.add_argument("op", choices=["spgemm", "spmv"])
    p.add_argument("folder", help="matrix directory (ssget-style)")
    p.add_argument("list_file", help="file with one matrix name per line")
    p.add_argument("out", nargs="?", default=None,
                   help="output file (default: <op>_out.txt, appended)")
    p.add_argument("--args", default="",
                   help="extra args passed through to the per-matrix driver")
    args = p.parse_args(argv)

    out_path = args.out or f"{args.op}_out.txt"
    with open(args.list_file) as f:
        names = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]

    if args.op == "spgemm":
        from .spgemm import main as run_one

        def argv_for(name):
            return [args.folder, name, name] + args.args.split()
    else:
        from .spmv import main as run_one

        def argv_for(name):
            return [args.folder, name] + args.args.split()

    failures = 0
    with open(out_path, "a") as out:
        for name in names:
            out.write(f"==== {name} ====\n")
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = run_one(argv_for(name))
            except Exception as e:  # sweep survives bad matrices
                buf.write(f"ERROR: {e}\n")
                rc = 1
            out.write(buf.getvalue())
            out.write(f"(wall {time.perf_counter()-t0:.2f}s, rc={rc})\n")
            out.flush()
            print(f"{name}: rc={rc}", file=sys.stderr)
            failures += rc != 0
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
