"""Multi-device scaling report — the SURVEY.md §7.6 deliverable.

What a run can establish without timing real collectives:

  * the sharded ops compile, execute on the mesh, and match the oracle;
  * per-shard work balance;
  * exact per-multiply exchange payloads (plan-time quantities: the
    all-gather of v moves (d-1)/d of the vector to every device, a halo
    exchange its two halo slices, the sharded-product exchange exactly
    the needed B tiles, padded per pair).

Timings from the CPU simulator are recorded as such and say nothing
about a GPU; collective times come from a profiler trace on the cards.

Usage:
  python -m bmsparse.cli.scaling --synthetic band --n 262144 \
      [--devices 1,2,4,8] [--report SCALING.json] [--cpu-sim]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _estimate_spgemm_tasks(m) -> int:
    """Cheap host-side task-volume estimate for C = A @ A (B = A^T
    layout): every A block (i, k) pairs with every block of A's block
    column k. Pure numpy on the container's block coordinates — used to
    refuse CPU-sim SpGEMM planning that cannot finish (a 256k-row
    webgraph's hubs produce 131M tasks; the plan tables alone would be
    ~6 GB)."""
    bcol = np.asarray(m.bcol)[: int(m.nb)]
    per_col = np.bincount(bcol, minlength=max(int(bcol.max(initial=0)) + 1, 1))
    return int(per_col[bcol].sum())


def build_report(m, sizes, v, mesh_fn, iters=5, run_sim=True,
                 spgemm_task_budget: int = 20_000_000) -> dict:
    import jax

    from ..parallel.partition import partition
    from ..parallel.plan import prepare_sharded
    from ..parallel.spmv import sharded_spmv_prepared
    from ..utils.timing import time_op

    v_bytes = m.num_cols * 4
    report = {
        "matrix": {"shape": list(m.shape), "nnz": m.nnz,
                   "blocks": int(m.nb)},
        "note": "payload bytes are exact plan-time quantities; timings "
                "are from the backend named in 'backend' and validate "
                "execution only",
        "backend": jax.devices()[0].platform,
        "spmv": [],
        "spgemm": [],
    }

    for d in sizes:
        row = {"d": d}
        # plan-time halo analysis works for ANY d (host-side); only the
        # simulator execution needs real (virtual) devices
        sm = partition(m, d, align=16)
        sp = prepare_sharded(sm)
        halo = sp.halo
        if run_sim and d <= len(jax.devices()):
            mesh = mesh_fn(d)
            nbs = np.asarray(sm.nb)
            t, u = time_op(
                lambda: sharded_spmv_prepared(sp, v, mesh),
                iters=iters,
            )
            ref = m.to_scipy() @ np.asarray(v)
            err = float(np.max(np.abs(np.asarray(u) - ref))
                        / max(float(np.max(np.abs(ref))), 1e-30))
            row["measured_sim"] = {
                "ok": bool(err < 1e-3),
                "max_rel_err": err,
                "exchange": "halo" if (halo and d > 1) else "allgather",
                "shard_imbalance": float(nbs.max() / max(nbs.mean(), 1e-9)),
                "seconds_on_backend": t,
            }
        # payload: plan-proven halo windows move O(halo) bytes per device
        # over two neighbour ppermutes; general sparsity all-gathers v
        row["exchange"] = "halo" if (halo and d > 1) else "allgather"
        row["exchange_bytes_per_device"] = (
            (halo[0] + halo[1]) * 4 if (halo is not None and d > 1)
            else int(v_bytes * (d - 1) / d))
        report["spmv"].append(row)

    # SpGEMM (A . A, B in transposed layout): selective-exchange payloads
    try:
        from .. import coo_to_bmsparse
        from ..parallel.product import (
            prepare_sharded_product, sharded_multiply,
        )

        est_tasks = _estimate_spgemm_tasks(m)
        if est_tasks > spgemm_task_budget:
            report["spgemm_skipped"] = {
                "estimated_tasks": est_tasks,
                "task_budget": spgemm_task_budget,
                "note": "A@A task volume exceeds the host/CPU-sim "
                        "planning budget; rerun with a smaller --n or "
                        "raise --spgemm-task-budget",
            }
            return report

        sco = m.to_scipy().tocoo()
        bt = coo_to_bmsparse(
            sco.row.astype(np.int32), sco.col.astype(np.int32),
            sco.data.astype(np.float32), m.shape, transposed=True,
            backend="host",
        )
        for d in sizes:
            if d < 2:
                continue
            row = {"d": d}
            # planning is host-side: plans/byte counts work for ANY d;
            # only the simulator execution needs real (virtual) devices
            sa = partition(m, d, align=16)
            sb = partition(bt, d, align=16)
            spp = prepare_sharded_product(sa, sb)
            # comm_bytes_selective charges the WIRE (every off-diagonal
            # pair padded to max_send); comm_bytes_useful counts real
            # tiles only — the gap is the padding overhead the exchange
            # actually pays. exchange records the planner's choice
            # (selective vs the skew all-gather fallback).
            sel = spp.comm_bytes_selective
            allg = spp.comm_bytes_allgather
            row["exchange"] = spp.exchange
            row["max_send"] = int(spp.max_send)
            row["selective_wire_bytes_total"] = int(sel)
            row["selective_useful_bytes_total"] = int(
                spp.comm_bytes_useful)
            row["allgather_bytes_total"] = int(allg)
            row["selective_fraction"] = sel / max(allg, 1)
            row["padding_overhead"] = sel / max(spp.comm_bytes_useful, 1)
            row["plan_seconds_host"] = float(spp.plan_seconds)
            if run_sim and d <= len(jax.devices()):
                c = sharded_multiply(spp, mesh_fn(d))
                cb = c.to_bmsparse()
                refm = (m.to_scipy() @ m.to_scipy()).tocsr()
                diff = abs(cb.to_scipy().tocsr() - refm)
                dmax = diff.max() if diff.nnz else 0.0
                err = float(dmax / max(abs(refm).max(), 1e-30))
                row["measured_sim"] = {
                    "ok": bool(err < 1e-3), "max_rel_err": err,
                }
                if "overlap_hlo" not in report:
                    report["overlap_hlo"] = probe_overlap_hlo(
                        spp, mesh_fn(d))
            report["spgemm"].append(row)
    except Exception as e:  # pragma: no cover
        report["spgemm_error"] = repr(e)
    return report


def probe_overlap_hlo(spp, mesh) -> dict:
    """Inspect the COMPILED schedule of the sharded multiply: does the
    exchange collective get emitted as an async start/done pair with
    independent work scheduled between (overlap possible), or as a
    blocking op (serialized)? The answer is recorded with its backend:
    a schedule says nothing about another backend's."""
    import jax

    from ..parallel.product import _multiply_fn

    operands = [
        spp.a_flat, spp.b_flat, spp.send_idx,
        spp.sig_hi, spp.sig_lo, spp.sig_off,
        *spp.tas, *spp.tbs,
    ]
    fn = _multiply_fn(spp.nnz_pad, spp.impl, spp.exchange,
                      len(operands), mesh)
    try:
        txt = fn.lower(*operands).compile().as_text()
    except Exception as e:  # pragma: no cover
        return {"error": repr(e)}
    res: dict = {"backend": jax.devices()[0].platform}
    for coll in ("all-to-all", "all-gather", "collective-permute"):
        start = txt.find(f"{coll}-start")
        if start < 0:
            continue
        done = txt.find(f"{coll}-done", start)
        between = txt[start:done].count("\n") if done > start else 0
        # overlap evidence: independent instructions scheduled between
        # the start and the done (the A-side gathers/products)
        res[coll] = {
            "async_emitted": True,
            "instructions_between_start_done": between,
            "overlapped": between > 1,
        }
    if len(res) == 1:
        res["async_emitted"] = False
        res["note"] = ("collectives emitted synchronously by this "
                       "backend; no overlap in the schedule")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bmsparse-scaling")
    p.add_argument("folder", nargs="?", help="matrix directory")
    p.add_argument("a_name", nargs="?", help="matrix name (without .mtx)")
    p.add_argument("--synthetic", choices=["band", "stencil", "web"],
                   default=None)
    p.add_argument("--n", type=int, default=262144)
    p.add_argument("--devices", default=None,
                   help="comma-separated mesh sizes (default: 1..all)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--spgemm-task-budget", type=int, default=20_000_000,
                   help="skip the SpGEMM section (with a recorded reason) "
                        "when the A@A task estimate exceeds this")
    p.add_argument("--report", default=None, help="write JSON report here")
    p.add_argument("--cpu-sim", action="store_true",
                   help="force the CPU backend (use with XLA_FLAGS="
                        "--xla_force_host_platform_device_count=N)")
    from ._platform import add_platform_arg

    add_platform_arg(p)
    args = p.parse_args(argv)

    import jax

    if args.cpu_sim:
        jax.config.update("jax_platforms", "cpu")
    else:
        from ._platform import apply_platform

        apply_platform(args)

    import jax.numpy as jnp

    from .. import coo_to_bmsparse, mmread_bmsparse
    from ..parallel.mesh import make_mesh

    if args.synthetic:
        n = args.n
        rng = np.random.default_rng(0)
        if args.synthetic == "web":
            # power-law hub structure — the skew case the selective
            # exchange must survive (VERDICT r2: no webgraph row)
            from ..utils.testmats import webgraph

            rows, cols, vals, shape = webgraph(n, avg_deg=8, seed=9)
            m = coo_to_bmsparse(rows, cols, vals, shape, backend="host")
        else:
            if args.synthetic == "stencil":
                offs = np.arange(-8, 9)
            else:
                offs = rng.integers(-8, 9, size=16)
            rows = np.repeat(np.arange(n, dtype=np.int64), len(offs))
            cols = np.clip(rows + np.tile(offs, n), 0, n - 1)
            key = np.unique(rows * n + cols)
            rows, cols = np.divmod(key, n)
            vals = rng.standard_normal(len(rows)).astype(np.float32)
            m = coo_to_bmsparse(
                rows.astype(np.int32), cols.astype(np.int32), vals,
                (n, n), backend="host",
            )
    elif args.folder and args.a_name:
        import os

        m = mmread_bmsparse(os.path.join(args.folder, args.a_name))
    else:
        p.error("need folder+name or --synthetic")

    total = len(jax.devices())
    sizes = ([int(x) for x in args.devices.split(",")] if args.devices
             else [d for d in (1, 2, 4, 8, 16, 32) if d <= total])
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.standard_normal(m.num_cols).astype(np.float32))

    print(f"matrix {m.shape}, nnz {m.nnz}; devices available: {total}")
    report = build_report(m, sizes, v, make_mesh, iters=args.iters,
                          spgemm_task_budget=args.spgemm_task_budget)
    if "spgemm_skipped" in report:
        sk = report["spgemm_skipped"]
        print(f"  spgemm: skipped ({sk['estimated_tasks']} estimated "
              f"tasks > budget {sk['task_budget']})")
    for row in report["spmv"]:
        ms = row.get("measured_sim", {})
        print(f"  spmv d={row['d']:3d}: {row['exchange']} exchange "
              f"{row['exchange_bytes_per_device']} B/device"
              + (f"; run ok={ms['ok']} imbalance "
                 f"{ms['shard_imbalance']:.2f}" if ms else ""))
    for row in report["spgemm"]:
        if "selective_fraction" in row:
            print(f"  spgemm d={row['d']:3d}: selective exchange "
                  f"{row['selective_fraction']*100:.1f}% of all-gather "
                  f"bytes"
                  + (f"; run ok={row['measured_sim']['ok']}"
                     if "measured_sim" in row else ""))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
