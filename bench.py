#!/usr/bin/env python
"""Benchmark driver: bmSparse SpMV + SpGEMM throughput on one GPU.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

value       = headline SpMV throughput (Gnnz/s) on the benchmark suite
vs_baseline = fraction of the device-memory roofline achieved (the
  reference publishes no numbers — BASELINE.md).

Suite: the reference's in-repo data/real matrix (Pajek/Ragusa16) plus the
SuiteSparse-scale matrices of utils/testmats.SUITE (banded, stencil,
uniform-random, blockdense, FEM, road and web structures).
Timing uses dependent fori_loop chains (one dispatch per measurement) —
see bmsparse/utils/benchit.py for why.

Diagnostics go to stderr and bench_detail.json. Refuses to run without
a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np


_T0 = None


def log(*a):
    import time as _t

    global _T0
    if _T0 is None:
        _T0 = _t.monotonic()
    print(f"[{_t.monotonic()-_T0:7.1f}s]", *a, file=sys.stderr, flush=True)


def main():
    import os
    import signal
    import time

    os.environ.setdefault("RUST_LOG", "error")

    import jax
    import jax.numpy as jnp

    from bmsparse.config import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {dev.platform!r}")
    enable_compile_cache()

    budget_s = float(os.environ.get("BMSP_BENCH_BUDGET_S", 420))
    deadline = time.monotonic() + budget_s
    headline_gnnz = 0.0
    headline_frac = 0.0

    # If the harness kills us before the budget expires, still emit the
    # headline JSON with whatever has been measured so far.
    def _emit_and_exit(signum, frame):  # pragma: no cover
        print(json.dumps({
            "metric": "bmsparse_spmv_throughput",
            "value": round(headline_gnnz, 4),
            "unit": "Gnnz/s",
            "vs_baseline": round(headline_frac, 4),
        }), flush=True)
        os._exit(0)

    signal.signal(signal.SIGTERM, _emit_and_exit)

    def time_left():
        return deadline - time.monotonic()

    from bmsparse import coo_to_bmsparse, mmread_bmsparse
    from bmsparse.io.binary import load_prepared, save_prepared
    from bmsparse.ops.plan import PLAN_LAYOUT_VERSION, cast_prepared, prepare
    from bmsparse.ops.spmv import spmv
    from bmsparse.utils import roofline as rl
    from bmsparse.utils.benchit import time_chain
    from bmsparse.config import bucket_size
    from bmsparse.utils.testmats import suite_matrix

    bw_spec = rl.device_hbm_gbps(dev)
    # the roofline denominator is the published peak; a triad (a+b*s:
    # 2 reads + 1 write) measured in the same run says what a plain
    # stream reaches on this card
    big = jnp.ones((64 * 1024 * 1024,), jnp.float32)   # 256 MB
    t_triad = time_chain(
        lambda s, b: b + s[:1] * jnp.float32(1e-30) + s,
        big, iters=8, args=(big * 2.0,))
    bw_meas = 3 * big.size * 4 / t_triad / 1e9
    bw = bw_spec
    log(f"device: {dev.device_kind}, memory spec {bw_spec} GB/s, measured "
        f"triad {bw_meas:.0f} GB/s")

    detail: dict = {"device": str(dev.device_kind), "hbm_gbps_spec": bw_spec,
                    "hbm_gbps_measured_triad": bw_meas,
                    "hbm_gbps_used": bw,
                    "spmv": {}, "spgemm": {}}

    # Lazy suite: matrices are built on first use and cases run in
    # priority order (headline first) under the wall-clock budget.
    def _gen(name):
        if name == "Ragusa16":
            return mmread_bmsparse("data/real/A_matrix.mtx")
        return suite_matrix(name)

    _cache: dict = {}

    # bump when any generator's parameters change — the disk cache keys
    # on (name, version), so stale matrices cannot masquerade as new defs
    _SUITE_VERSION = 2

    def get_matrix(name):
        if name not in _cache:
            t0 = time.monotonic()
            # disk cache: the big host-converter builds cost 30-70 s each
            # and are deterministic; cache the container arrays
            ck = f"scratch/bench_mat_v{_SUITE_VERSION}_{name}.npz"
            if os.path.exists(ck):
                from bmsparse import load_bmsparse

                _cache[name] = load_bmsparse(ck)
            else:
                _cache[name] = _gen(name)
                try:
                    os.makedirs("scratch", exist_ok=True)
                    from bmsparse import save_bmsparse

                    save_bmsparse(ck, _cache[name])
                except Exception:  # pragma: no cover
                    pass
            log(f"{name}: built in {time.monotonic()-t0:.1f}s")
        return _cache[name]

    _plan_cache: dict = {}

    def get_plan(name, m):
        """Tiered SpMV plan, disk-cached: the host plan build is
        deterministic and costs seconds per SuiteSparse-scale matrix."""
        if name in _plan_cache:
            return _plan_cache[name]
        ck = (f"scratch/bench_plan_v{_SUITE_VERSION}."
              f"{PLAN_LAYOUT_VERSION}_{name}.pkl")
        t0 = time.monotonic()
        mp = None
        if os.path.exists(ck):
            try:
                mp = load_prepared(ck, m)
            except Exception as e:  # pragma: no cover
                log(f"{name}: plan cache load failed: {e}")
        how = "loaded"
        if mp is None:
            mp = prepare(m)
            how = "built"
            try:
                save_prepared(ck, mp)
            except Exception as e:  # pragma: no cover
                log(f"{name}: plan cache save failed: {e}")
        log(f"{name}: plan {how} in {time.monotonic()-t0:.1f}s")
        _plan_cache[name] = mp
        return mp


    def bench_spmv(name, m):
        nonlocal headline_gnnz, headline_frac
        if time_left() < 40:
            log(f"SpMV {name}: skipped (bench budget)")
            return
        v0 = jnp.asarray(
            np.random.default_rng(0).standard_normal(m.num_cols).astype(np.float32)
        )
        nnz, nb = m.nnz, int(m.nb)
        min_bytes = rl.spmv_min_bytes(nnz, nb, m.num_rows, m.num_cols)
        roof = rl.roofline_nnz_per_s(min_bytes, nnz, bw)
        roof_vo = rl.roofline_nnz_per_s(
            rl.spmv_min_bytes_values_only(nnz), nnz, bw)
        mp = get_plan(name, m)
        cw = mp.sell_dense[0].shape[0] if mp.sell_dense else 0
        stream_slots = (int(mp.stream.vals_grid.shape[0]) * 128
                        if mp.stream is not None else 0)
        stream_res = (int(mp.stream.res_rows.shape[0])
                      if mp.stream is not None else 0)
        log(f"{name}: ndiags={len(mp.dia_offsets)} sell_ks={mp.sell_ks} "
            f"cw={cw} stream_slots={stream_slots} "
            f"stream_residue={stream_res}")
        for impl in ["auto"]:
            try:
                step = lambda s, mm: spmv(mm, s) * jnp.float32(1e-2)
                t = time_chain(step, v0, iters=30, args=(mp,))
            except Exception as e:
                import traceback as _tb
                log(f"SpMV {name} [{impl}] failed: {repr(e)[:500]}\n"
                    + _tb.format_exc(limit=6)[:2000])
                continue
            gnnz = nnz / t / 1e9
            frac = gnnz * 1e9 / roof
            frac_vo = gnnz * 1e9 / roof_vo
            log(f"SpMV {name} [{impl}]: nnz={nnz} blocks={nb} t={t*1e6:.1f}us "
                f"{gnnz:.3f} Gnnz/s ({frac*100:.1f}% of roofline; "
                f"{frac_vo*100:.1f}% of the values-only floor)")
            detail["spmv"][f"{name}:{impl}"] = dict(
                nnz=nnz, blocks=nb, seconds=t, gnnz_s=gnnz,
                roofline_frac=frac, values_only_frac=frac_vo,
                sell_cw=cw, total_sell_groups=len(mp.sell_ks),
                stream_slots=stream_slots, stream_residue=stream_res)
            # headline = the production-scale stencil case (the classic
            # PDE SpMV family; its 143 MB strip is larger than the L2
            # cache); band2M is the fallback
            if name == "stencil2M" or (
                headline_gnnz == 0.0
                and name not in ("Ragusa16", "rand64k")
            ):
                headline_gnnz, headline_frac = gnnz, frac

        if name in ("stencil2M", "band2M") and time_left() > 60:
            # bonus line: bf16 tier storage (the reference's half-input
            # regime; fp32 accumulation) — roughly halves memory traffic.
            # Derived by an on-device cast instead of a host rebuild.
            try:
                mp16 = cast_prepared(mp, jnp.bfloat16)
                step = lambda s, mm: spmv(mm, s) * jnp.float32(1e-2)
                t = time_chain(step, v0, iters=30, args=(mp16,))
                gnnz = nnz / t / 1e9
                log(f"SpMV {name} [bf16]: t={t*1e6:.1f}us "
                    f"{gnnz:.3f} Gnnz/s")
                detail["spmv"][f"{name}:bf16"] = dict(
                    nnz=nnz, seconds=t, gnnz_s=gnnz)
            except Exception as e:  # pragma: no cover
                log(f"SpMV {name} [bf16] failed: {e}")

    # ---- SpGEMM (A . A, like the reference batch harness) ----------------
    # Three measurements per case:
    #   e2e   — one warm one-shot spgemm() wall time (includes every host
    #           sync; the number a user of the reference CLI would see);
    #   sym / plan / num — the jitted stages as dependent chains (pure
    #           device time; plan is the on-device numeric planner);
    #   roofline fraction — num phase vs utils.roofline.spgemm_min_bytes.
    from bmsparse.ops import spgemm as sg
    from bmsparse.ops.product import prepare_product

    def bench_spgemm(name, m, impl="auto", e2e_only=False):
        if time_left() < 90:
            log(f"SpGEMM {name}: skipped (bench budget)")
            return
        try:
            bt_src = m.to_scipy().tocoo()
            bt = coo_to_bmsparse(
                bt_src.row.astype(np.int32), bt_src.col.astype(np.int32),
                bt_src.data.astype(np.float32), m.shape, transposed=True,
                backend="host",
            )
            cnt, offs, brs, total = sg._task_counts(m, bt, bt.block_rows)
            ntasks = int(total)
            if ntasks > 16_000_000:
                log(f"SpGEMM {name}: skipped ({ntasks} tasks)")
                return
            t_pad = bucket_size(max(ntasks, 1))
            sentinel = m.block_rows + 1

            # warm one-shot (compiles every stage), then timed one-shot;
            # skipped under tight budget so the cheaper phase chains
            # below still record (the e2e costs two full spgemm walls
            # plus their compiles)
            t_e2e = None
            if e2e_only or time_left() > 150:
                c = sg.spgemm(m, bt, impl=impl)
                jax.block_until_ready(c.values)
                th0 = time.monotonic()
                c = sg.spgemm(m, bt, impl=impl)
                jax.block_until_ready(c.values)
                t_e2e = time.monotonic() - th0
                nbc, cnnz = int(c.nb), c.nnz
                log(f"SpGEMM {name}: tasks={ntasks} Cblocks={nbc} "
                    f"Cnnz={cnnz} e2e={t_e2e*1e3:.1f}ms "
                    f"(warm one-shot incl host syncs)")
                detail["spgemm"].setdefault(name, {}).update(
                    tasks=ntasks, c_blocks=nbc, c_nnz=cnnz,
                    e2e_seconds=t_e2e)
            if e2e_only:
                return

            def sym_step(hi, mm, bb):
                m2 = dataclasses.replace(mm, bmp_hi=hi)
                _, offs2, brs2, total2 = sg._task_counts(m2, bb, bb.block_rows)
                ai, bi, kr, kc, ph2, pl2, nz2 = sg._build_tasks(
                    m2, bb, offs2, brs2, total2, t_pad, sentinel)
                cs2, tbl2, nbc2, nnz2 = sg._c_symbolic_scan(
                    ph2, pl2, kr, kc, sentinel, ai, bi)
                # consume the full symbolic result so XLA cannot
                # dead-code-slice the phase
                dep = (jnp.sum(tbl2).astype(jnp.uint32)
                       + jnp.sum(cs2).astype(jnp.uint32)
                       + nnz2.astype(jnp.uint32))
                return hi ^ (dep >> 31)

            if time_left() < 100:
                log(f"SpGEMM {name}: phase chains skipped (bench budget)")
                return
            t_sym = time_chain(sym_step, m.bmp_hi, iters=10, args=(m, bt))

            # structure plan (cached product): exposes the device planner
            # and the cached numeric stage separately
            th0 = time.monotonic()
            pp = prepare_product(m, bt, impl=impl)
            t_prep = time.monotonic() - th0
            p = pp.plan
            nbc, cnnz = p.num_c_blocks, p.num_c_nnz
            nbc_pad = p.nbc_pad

            def plan_step(cs, keys_tbl):
                import jax as _jax
                outs = sg._plan_sell_device(
                    cs, jnp.int32(p.num_alive), jnp.int32(p.num_c_blocks),
                    nbc_pad, keys_tbl)
                dep = sum(jnp.sum(o).astype(jnp.int32)
                          for o in _jax.tree_util.tree_leaves(outs))
                return cs ^ (dep >> 30)

            # plan data goes through args, never closures: closed-over
            # device arrays become HLO constants of the program
            t_plan = time_chain(plan_step, p.c_seg, iters=10,
                                args=(p.keys_tbl,))

            ks = tuple(kg for kg, _, _ in p.groups)

            def num_step(af, bf, tas, tbs, sig_st, win_starts, g_tbl):
                # af is the loop carry, so the whole stage depends on it
                # (no hoisting); the return folds the FULL cv back into
                # the carry — a single-element dependence lets XLA
                # dead-code-eliminate most of the numeric phase (measured!)
                cv = sg._numeric_stage(
                    af, bf, tas, tbs,
                    sig_st[0], sig_st[1], sig_st[2],
                    win_starts, g_tbl,
                    tuple(p.groups), pp.impl, p.nnz_pad,
                    win=p.win, compress=p.compress_mode)
                return af + (
                    jnp.sum(cv) * jnp.float32(1e-30)
                ).astype(af.dtype)

            num_args = (p.tas, p.tbs, p.sig_st, p.win_starts, p.g_tbl)
            if time_left() < 60:
                log(f"SpGEMM {name}: sym={t_sym*1e3:.2f}ms, num skipped "
                    "(bench budget)")
                return
            t_num = time_chain(num_step, p.a_flat, iters=10,
                               args=(p.b_flat,) + num_args)
            t_dev = t_sym + t_plan + t_num
            gnnz = cnnz / t_dev / 1e9
            min_bytes = rl.spgemm_min_bytes(
                m.nnz, int(m.nb), bt.nnz, int(bt.nb), ntasks, cnnz, nbc)
            num_roof = min_bytes / bw / 1e9   # seconds at memory speed
            num_frac = num_roof / max(t_num, 1e-12)
            nwin = sum(1 for wa, wb in p.win if wa or wb)
            log(f"SpGEMM {name} [{pp.impl}]: sym={t_sym*1e3:.2f}ms "
                f"plan={t_plan*1e3:.2f}ms num={t_num*1e3:.2f}ms "
                f"ks={ks} compress={p.compress_mode} "
                f"win={nwin}/{len(p.win)} "
                f"{gnnz:.3f} Gnnz(C)/s "
                f"(num phase {num_frac*100:.1f}% of roofline)")
            detail["spgemm"][name] = dict(
                tasks=ntasks, c_blocks=nbc, c_nnz=cnnz, impl=pp.impl,
                e2e_seconds=t_e2e, prepare_product_seconds=t_prep,
                sym_seconds=t_sym, plan_seconds=t_plan,
                num_seconds=t_num, gnnz_s=gnnz,
                num_roofline_frac=num_frac,
                compress_mode=p.compress_mode, jmax=p.jmax,
                windowed_groups=nwin, total_groups=len(p.win))

            # bf16 operand tiles (the reference's half-input regime:
            # half traffic in the gather-dominated numeric phase)
            if time_left() > 150:
                af16 = p.a_flat.astype(jnp.bfloat16)
                bf16 = p.b_flat.astype(jnp.bfloat16)
                t16 = time_chain(num_step, af16, iters=10,
                                 args=(bf16,) + num_args)
                log(f"SpGEMM {name} [bf16 tiles]: num={t16*1e3:.2f}ms")
                detail["spgemm"][name]["num_bf16_seconds"] = t16
        except Exception as e:
            # repr + traceback: str(e) alone can be empty
            import traceback as _tb
            log(f"SpGEMM {name} failed: {repr(e)[:500]}\n"
                + _tb.format_exc(limit=6)[:2000])

    # priority schedule: cheap high-value phase chains FIRST so the run
    # records the most cases inside its budget — band2M SpMV (f32+bf16)
    # and a >2M-task SpGEMM phase chain before the minute-scale border4M
    # e2e; tiny/adversarial cases last
    _build_est = {"band2M": 75, "stencil2M": 55, "blockdense1M": 20,
                  "border4M": 80}
    for kind, name in [
        ("spmv", "stencil2M"),
        ("spmv", "band2M"),
        ("spgemm", "band256k"),
        ("spmv", "blockdense1M"),
        ("spmv", "fem1M"),
        # the scattered-structure cases come BEFORE the big SpGEMM chain
        ("spmv", "road1M"),
        ("spmv", "web256k"),
        ("spgemm", "band2M"),
        ("spgemm-e2e", "border4M"),
        ("spgemm", "blockdense64k"),
        ("spmv", "blockdense64k"),
        ("spgemm", "fem1M"),
        ("spmv", "band256k"),
        ("spmv", "Ragusa16"),
        ("spgemm", "Ragusa16"),
        ("spmv", "rand64k"),
        ("spgemm", "rand64k"),
    ]:
        # budget check BEFORE the (possibly minute-scale) matrix build
        need = (50 if kind == "spmv" else 90) + (
            0 if name in _cache else _build_est.get(name, 5)
        )
        if time_left() < need:
            log(f"{kind} {name}: skipped before build (bench budget)")
            continue
        try:
            m = get_matrix(name)
        except Exception as e:  # pragma: no cover
            log(f"{name}: build failed: {e}")
            continue
        if kind == "spmv":
            bench_spmv(name, m)
        else:
            bench_spgemm(name, m, e2e_only=(kind == "spgemm-e2e"))

    with open("bench_detail.json", "w") as f:
        json.dump(detail, f, indent=2)

    log("==== recorded cases ====")
    for k, v in detail["spmv"].items():
        frac = v.get("roofline_frac")
        log(f"  spmv {k}: {v.get('gnnz_s', 0):.2f} Gnnz/s"
            + (f" ({frac*100:.1f}% roofline)" if frac is not None else ""))
    for k, v in detail["spgemm"].items():
        log(f"  spgemm {k}: tasks={v.get('tasks')} "
            f"e2e={v.get('e2e_seconds', 0)*1e3:.0f}ms "
            f"sym={v.get('sym_seconds', 0)*1e3:.1f}ms "
            f"plan={v.get('plan_seconds', 0)*1e3:.1f}ms "
            f"num={v.get('num_seconds', 0)*1e3:.1f}ms")

    print(json.dumps({
        "metric": "bmsparse_spmv_throughput",
        "value": round(headline_gnnz, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(headline_frac, 4),
    }))


if __name__ == "__main__":
    main()
