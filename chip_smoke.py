#!/usr/bin/env python
"""Smoke test of bmsparse on an NVIDIA GPU, through the public entry points.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded phase only

Phases (one process, one JAX client for all cards):
  1. device stamp: platform, device kind and count, JAX version,
     nvidia-smi name and power limit, XLA_FLAGS, compile cache;
  2. the reference-style CLIs (cli/spmv.py, cli/spgemm.py) on data/real,
     each with its "Final:" oracle comparison;
  3. prepare + spmv on SuiteSparse-scale suite matrices (utils/testmats.py)
     against scipy in float64, and a bf16 plan made by cast_prepared;
  4. one-shot spgemm and a prepare_product re-multiply of band2M A.A against
     scipy in float64, the same with bf16 operand tiles, and the fused
     Triton numeric kernel (impl="pallas") against impl="sell";
  5. the test suite's `gpu`-marked tests (pytest, in this process);
  6. peak device memory after every phase.
With --cards 4: partition + prepare_sharded + halo-exchange sharded SpMV on
stencil2M, and prepare_sharded_product + sharded_multiply on band2M A.A,
each against the single-card result and scipy, with every shard's arrays
checked to sit on their own card.

Exits non-zero, printing no result line, when JAX finds no GPU or any
check fails. The last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SPMV_CASES = ("stencil2M", "road1M", "blockdense1M", "web256k")
SPGEMM_CASE = "band2M"
SHARDED_SPMV_CASE = "stencil2M"
# max|x - ref| <= REL_TOL * max|ref|: float32 accumulation against a
# float64 reference over the same (possibly bf16-rounded) values; the
# gap is summation order only (no matrix product, so no TF32).
REL_TOL = 1e-4
# fused Triton numeric vs the XLA task-SELL numeric on one plan: both
# accumulate in float32, in different orders.
IMPL_TOL = 1e-5
CLI_TOL = 1e-2          # the CLIs' own oracle tolerance (bf16 SpGEMM CLI)

_T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[{time.monotonic() - _T0:7.1f}s] {msg}", flush=True)


def check(what: str, err: float, tol: float) -> None:
    log(f"  {what}: rel err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{what}: rel err {err} > {tol}")


def rel_err(x, ref) -> float:
    import numpy as np

    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    if x.shape != ref.shape:
        raise AssertionError(f"shape {x.shape} != reference {ref.shape}")
    if not np.isfinite(x).all():
        raise AssertionError("non-finite values in the result")
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


def bf16_round(x):
    import jax.numpy as jnp
    import numpy as np

    return np.asarray(np.asarray(x, np.float32).astype(jnp.bfloat16),
                      np.float64)


def log_peak(phase: str) -> None:
    import jax

    for d in jax.local_devices():
        stats = d.memory_stats() or {}
        log(f"peak device memory after {phase} [{d.id}]: "
            f"{stats.get('peak_bytes_in_use')} bytes")


# ---------------------------------------------------------------------------
def phase_stamp() -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r} "
            f"({devs[0].device_kind})")
    from bmsparse.config import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}, "
        f"jax {jax.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile cache={cache}")
    print(smi, flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _run_cli(main_fn, argv) -> float:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    m = re.search(r"^Final: (\S+)", out, re.M)
    if rc != 0 or m is None:
        raise AssertionError(f"CLI {argv} rc={rc}, no Final: line")
    return float(m.group(1))


def phase_clis() -> None:
    from bmsparse.cli import spgemm as cli_spgemm
    from bmsparse.cli import spmv as cli_spmv

    data = os.path.join(ROOT, "data", "real")
    check("cli.spmv Final", _run_cli(
        cli_spmv.main, [data, "A_matrix", "--check"]), CLI_TOL)
    check("cli.spgemm Final", _run_cli(
        cli_spgemm.main, [data, "A_matrix", "B_matrix", "--check"]),
        CLI_TOL)


# ---------------------------------------------------------------------------
def _tiers(p) -> str:
    cw = p.sell_dense[0].shape[0] if p.sell_dense else 0
    return (f"dia={len(p.dia_offsets)} sell_ks={p.sell_ks} cw={cw} "
            f"stream={'yes' if p.stream is not None else 'no'}")


def spmv_case(name: str, m, bf16: bool = False) -> None:
    import jax.numpy as jnp
    import numpy as np

    from bmsparse import spmv
    from bmsparse.ops.plan import cast_prepared, prepare

    t0 = time.monotonic()
    p = prepare(m)
    log(f"{name}: nnz={m.nnz} plan {time.monotonic() - t0:.1f}s "
        f"{_tiers(p)}")
    v = np.random.default_rng(0).standard_normal(m.num_cols).astype(
        np.float32)
    a = m.to_scipy().tocsr()
    u = spmv(p, jnp.asarray(v))
    check(f"{name} spmv f32", rel_err(u, a @ v.astype(np.float64)),
          REL_TOL)
    if bf16:
        p16 = cast_prepared(p, jnp.bfloat16)
        a.data = bf16_round(a.data)
        u16 = spmv(p16, jnp.asarray(v))
        check(f"{name} spmv bf16 plan", rel_err(
            u16, a @ v.astype(np.float64)), REL_TOL)


def phase_spmv(names=SPMV_CASES) -> None:
    from bmsparse.utils.testmats import suite_matrix

    for name in names:
        spmv_case(name, suite_matrix(name), bf16=(name == "stencil2M"))
        log_peak(f"spmv {name}")


def _csr_sorted(x):
    x = x.tocsr()
    x.sum_duplicates()
    x.sort_indices()
    return x


def product_ref(a):
    """scipy float64 reference for A.A: (structural pattern, values). The
    pattern comes from |A|.|A|, which cannot cancel (scipy drops entries
    that sum to exactly zero; C keeps them, as the reference does)."""
    a = a.tocsr()
    return _csr_sorted(abs(a) @ abs(a)), _csr_sorted(a @ a)


def product_err(c, ref) -> float:
    """C (BmSparse) against product_ref: the same nonzero count and
    pattern, then max|C - C_ref| / max|C_ref|."""
    import numpy as np

    pattern, values = ref
    got = _csr_sorted(c.to_scipy())
    if got.nnz != pattern.nnz or not (
            np.array_equal(got.indptr, pattern.indptr)
            and np.array_equal(got.indices, pattern.indices)):
        raise AssertionError(
            f"pattern differs: {got.nnz} nonzeros vs {pattern.nnz}")
    if not np.isfinite(got.data).all():
        raise AssertionError("non-finite values in C")
    diff = abs(got - values)
    return float((diff.max() if diff.nnz else 0.0)
                 / max(abs(values).max(), 1e-30))


def spgemm_case(name: str, a, bt) -> None:
    import jax
    import jax.numpy as jnp

    from bmsparse import spgemm
    from bmsparse.ops.product import prepare_product

    a_s = a.to_scipy().tocsr()
    ref = product_ref(a_s)
    t0 = time.monotonic()
    c = spgemm(a, bt)
    jax.block_until_ready(c.values)
    log(f"{name} A.A: C blocks={int(c.nb)} nnz={c.nnz} one-shot "
        f"{time.monotonic() - t0:.1f}s (with compile)")
    check(f"{name} spgemm", product_err(c, ref), REL_TOL)
    pp = prepare_product(a, bt)
    check(f"{name} prepare_product re-multiply", product_err(pp(), ref),
          REL_TOL)

    c_sell = spgemm(a, bt, impl="sell")
    c_pal = spgemm(a, bt, impl="pallas")
    if c_sell.nnz != c_pal.nnz:
        raise AssertionError("impl='pallas' and impl='sell' C differ")
    check(f"{name} impl=pallas vs impl=sell", rel_err(
        c_pal.values[: c_pal.nnz], c_sell.values[: c_sell.nnz]), IMPL_TOL)

    a16, bt16 = a.astype(jnp.bfloat16), bt.astype(jnp.bfloat16)
    a_s.data = bf16_round(a_s.data)
    check(f"{name} spgemm bf16 tiles", product_err(
        spgemm(a16, bt16), (ref[0], _csr_sorted(a_s @ a_s))), REL_TOL)


def phase_spgemm(name: str = SPGEMM_CASE) -> None:
    from bmsparse.utils.testmats import suite_matrix

    spgemm_case(name, suite_matrix(name),
                suite_matrix(name, transposed=True))
    log_peak(f"spgemm {name}")


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def phase_gpu_tests() -> None:
    """Run the suite's gpu-marked tests on this process's card."""
    import pytest

    os.environ["BMSP_TEST_DEVICE"] = "gpu"   # tests/conftest.py: no CPU pin
    counts = _Outcomes()
    rc = pytest.main([os.path.join(ROOT, "tests"), "-q", "-m", "gpu",
                      "-p", "no:cacheprovider"], plugins=[counts])
    log(f"gpu tests: {counts.passed} passed, {counts.failed} failed, "
        f"{counts.skipped} skipped (rc={rc})")
    if rc != 0 or counts.failed or counts.skipped or not counts.passed:
        raise AssertionError("gpu-marked tests did not all pass")


# ---------------------------------------------------------------------------
def _check_placement(what: str, tree, mesh) -> None:
    import jax

    want = list(mesh.devices.flat)
    for leaf in jax.tree_util.tree_leaves(tree):
        shards = sorted(leaf.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        got = [s.device for s in shards]
        if got != want:
            raise AssertionError(
                f"{what}: shards on {got}, expected one per card {want}")
    log(f"  {what}: every array has one shard per card")


def sharded_case(spmv_m, a, bt, cards: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bmsparse import spgemm, spmv
    from bmsparse.ops.plan import prepare
    from bmsparse.parallel.mesh import make_mesh, place_on_mesh
    from bmsparse.parallel.partition import partition
    from bmsparse.parallel.plan import prepare_sharded
    from bmsparse.parallel.product import (
        prepare_sharded_product, sharded_multiply,
    )
    from bmsparse.parallel.spmv import sharded_spmv_prepared

    mesh = make_mesh(cards)
    v = np.random.default_rng(0).standard_normal(spmv_m.num_cols).astype(
        np.float32)
    u1 = np.asarray(spmv(prepare(spmv_m), jnp.asarray(v)))
    t0 = time.monotonic()
    sp = place_on_mesh(prepare_sharded(partition(spmv_m, cards, align=16)),
                       mesh)
    log(f"sharded plan {time.monotonic() - t0:.1f}s halo={sp.halo}")
    _check_placement("sharded SpMV plan", sp, mesh)
    u = sharded_spmv_prepared(sp, jnp.asarray(v), mesh, exchange="halo")
    check("sharded halo spmv vs single card", rel_err(u, u1), REL_TOL)
    check("sharded halo spmv vs scipy", rel_err(
        u, spmv_m.to_scipy().tocsr() @ v.astype(np.float64)), REL_TOL)

    ref = product_ref(a.to_scipy())
    c1 = spgemm(a, bt)
    t0 = time.monotonic()
    spp = place_on_mesh(prepare_sharded_product(
        partition(a, cards, align=16), partition(bt, cards, align=16)),
        mesh)
    log(f"sharded product plan {time.monotonic() - t0:.1f}s "
        f"exchange={spp.exchange} impl={spp.impl}")
    _check_placement("sharded product plan", spp, mesh)
    cs = sharded_multiply(spp, mesh)
    jax.block_until_ready(cs.values)
    _check_placement("sharded product values", cs.values, mesh)
    c = cs.to_bmsparse()
    check("sharded product vs single card", product_err(
        c, (ref[0], _csr_sorted(c1.to_scipy()))), REL_TOL)
    check("sharded product vs scipy", product_err(c, ref), REL_TOL)


def phase_sharded(cards: int) -> None:
    from bmsparse.utils.testmats import suite_matrix

    sharded_case(suite_matrix(SHARDED_SPMV_CASE), suite_matrix(SPGEMM_CASE),
                 suite_matrix(SPGEMM_CASE, transposed=True), cards)
    log_peak("sharded")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded phase on four cards")
    args = ap.parse_args(argv)
    device = phase_stamp()
    if device["count"] < args.cards:
        raise SystemExit(
            f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
            f"JAX found {device['count']}")
    if args.cards == 4:
        phase_sharded(args.cards)
    else:
        phase_clis()
        log_peak("CLIs")
        phase_spmv()
        phase_spgemm()
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
