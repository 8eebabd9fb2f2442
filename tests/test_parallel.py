"""Multi-chip tests on the 8-virtual-device CPU mesh: partition round trip,
sharded SpMV (v all-gather halo exchange), sharded SpGEMM (B all-gather)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from bmsparse import coo_to_bmsparse, mean_relative_error
from bmsparse.parallel.mesh import make_mesh
from bmsparse.parallel.partition import partition
from bmsparse.parallel.spgemm import estimate_bounds, sharded_spgemm
from bmsparse.parallel.spmv import sharded_spmv

from conftest import random_coo


needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _make(shape, density, seed, transposed=False):
    rows, cols, vals = random_coo(*shape, density=density, seed=seed)
    m = coo_to_bmsparse(rows, cols, vals, shape, transposed=transposed)
    ref = sp.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=shape)
    return m, ref


@pytest.mark.parametrize("d", [2, 8])
def test_partition_roundtrip(d):
    m, ref = _make((200, 160), 0.04, seed=31)
    sm = partition(m, d)
    back = sm.to_bmsparse()
    assert mean_relative_error(back, ref) < 1e-6
    assert int(sm.nb.sum()) == int(m.nb)


@needs_8
@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_spmv(d):
    m, ref = _make((177, 203), 0.05, seed=37)
    sm = partition(m, d)
    mesh = make_mesh(d)
    v = np.random.default_rng(5).standard_normal(203).astype(np.float32)
    u = np.asarray(sharded_spmv(sm, jnp.asarray(v), mesh))
    np.testing.assert_allclose(u, ref @ v, rtol=1e-4, atol=1e-5)


@needs_8
def test_sharded_spmv_uneven_rows():
    # last shard owns a partial row range
    m, ref = _make((100, 100), 0.06, seed=41)
    sm = partition(m, 8)
    mesh = make_mesh(8)
    v = np.ones(100, np.float32)
    u = np.asarray(sharded_spmv(sm, jnp.asarray(v), mesh))
    np.testing.assert_allclose(u, ref @ v, rtol=1e-4, atol=1e-5)


@needs_8
@pytest.mark.parametrize("d", [2, 8])
def test_sharded_spgemm(d):
    a, a_ref = _make((96, 80), 0.06, seed=43)
    b, b_ref = _make((80, 112), 0.06, seed=44, transposed=True)
    sa = partition(a, d)
    sb = partition(b, d)
    mesh = make_mesh(d)
    bounds = estimate_bounds(sa, sb)
    c = sharded_spgemm(sa, sb, mesh, **bounds)
    c_full = c.to_bmsparse()
    assert mean_relative_error(c_full, (a_ref @ b_ref).tocsr()) < 1e-5


@needs_8
def test_sharded_matches_single_chip():
    a, a_ref = _make((64, 64), 0.1, seed=45)
    b, _ = _make((64, 64), 0.1, seed=46, transposed=True)
    from bmsparse.ops.spgemm import spgemm

    c1 = spgemm(a, b)
    sa, sb = partition(a, 4), partition(b, 4)
    c2 = sharded_spgemm(sa, sb, make_mesh(4), **estimate_bounds(sa, sb))
    for x, y in zip(c1.generate_coo(), c2.to_bmsparse().generate_coo()):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


def test_sharded_prepared_spmv():
    """Multi-chip fast path: per-shard tiered plans with unified statics
    (parallel/plan.py) must match the single-chip result exactly."""
    import jax.numpy as jnp

    from bmsparse.parallel.plan import prepare_sharded
    from bmsparse.parallel.spmv import sharded_spmv_prepared

    rng = np.random.default_rng(4)
    n = 1024
    # tridiagonal + scattered extras concentrated in the upper rows so
    # shard loads are skewed (exercises forced-group padding)
    r1 = np.repeat(np.arange(n), 3)
    c1 = np.clip(r1 + np.tile(np.arange(-1, 2), n), 0, n - 1)
    flat = rng.choice(n * n // 2, size=n * 2, replace=False)
    r2, c2 = np.divmod(flat, n)
    key = np.unique(np.concatenate([r1 * n + c1, r2 * n + c2]))
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    m = coo_to_bmsparse(
        rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)
    )
    nd = min(8, len(jax.devices()))
    mesh = make_mesh(nd)
    sm = partition(m, nd, align=16)
    spp = prepare_sharded(sm)
    assert len(spp.dia_offsets) <= 128
    v = rng.standard_normal(n).astype(np.float32)
    u = np.asarray(
        sharded_spmv_prepared(spp, jnp.asarray(v), mesh)
    )
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)) @ v
    np.testing.assert_allclose(u, ref, rtol=1e-4, atol=1e-5)


@needs_8
def test_sharded_prepared_spmv_tall_matrix():
    """Tall matrices (num_rows >> num_cols): late shards' column-shift
    bases exceed num_cols; the DIA slice source must cover them
    (regression for a dynamic_slice clamp that misaligned those shards)."""
    from bmsparse.parallel.plan import prepare_sharded
    from bmsparse.parallel.spmv import sharded_spmv_prepared

    n_rows, n_cols = 2048, 256
    r = np.arange(n_rows, dtype=np.int64)
    c = r % n_cols  # per-shard diagonals at strongly negative offsets
    vals = np.random.default_rng(7).standard_normal(n_rows).astype(np.float32)
    m = coo_to_bmsparse(
        r.astype(np.int32), c.astype(np.int32), vals, (n_rows, n_cols)
    )
    mesh = make_mesh(8)
    sm = partition(m, 8, align=16)
    spp = prepare_sharded(sm)
    assert spp.dia_offsets, "tall-diagonal structure should take the DIA tier"
    v = np.random.default_rng(8).standard_normal(n_cols).astype(np.float32)
    u = np.asarray(sharded_spmv_prepared(spp, jnp.asarray(v), mesh))
    ref = sp.csr_matrix((vals, (r, c)), shape=(n_rows, n_cols)) @ v
    np.testing.assert_allclose(u, ref, rtol=1e-5, atol=1e-5)


@needs_8
@pytest.mark.parametrize("d", [2, 8])
def test_sharded_product_selective_exchange(d):
    """Multi-chip SpGEMM fast path (parallel/product.py): host-planned
    task-SELL numeric per shard + selective all_to_all tile exchange must
    match the single-chip product exactly."""
    from bmsparse.ops.spgemm import spgemm
    from bmsparse.parallel.product import (
        prepare_sharded_product, sharded_multiply,
    )

    # banded structure: shards need only neighbouring B rows, so the
    # selective exchange moves far less than the full all-gather
    n = 512
    r1 = np.repeat(np.arange(n), 3)
    c1 = np.clip(r1 + np.tile(np.arange(-1, 2), n), 0, n - 1)
    key = np.unique(r1 * n + c1)
    rows, cols = np.divmod(key, n)
    vals = np.random.default_rng(11).standard_normal(
        len(rows)).astype(np.float32)
    a = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                        vals, (n, n))
    bt = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                         vals, (n, n), transposed=True)
    c_ref = spgemm(a, bt)

    sa, sb = partition(a, d, align=16), partition(bt, d, align=16)
    spp = prepare_sharded_product(sa, sb)
    assert spp.comm_bytes_selective < spp.comm_bytes_allgather
    c_sh = sharded_multiply(spp, make_mesh(d)).to_bmsparse()
    for x, y in zip(c_ref.generate_coo(), c_sh.generate_coo()):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


@needs_8
def test_sharded_product_value_update():
    """The sharded plan is structure-frozen: rebuilding operand tiles with
    new values (same structure) and re-multiplying must track them."""
    import dataclasses as dc

    from bmsparse.ops.spgemm import spgemm
    from bmsparse.parallel.product import (
        prepare_sharded_product, sharded_multiply,
    )

    rows, cols, vals = random_coo(256, 256, density=0.03, seed=55)
    a = coo_to_bmsparse(rows, cols, vals, (256, 256))
    bt = coo_to_bmsparse(rows, cols, vals, (256, 256), transposed=True)
    sa, sb = partition(a, 4, align=16), partition(bt, 4, align=16)
    spp = prepare_sharded_product(sa, sb)
    spp2 = dc.replace(spp, a_flat=spp.a_flat * 2.0)
    c_sh = sharded_multiply(spp2, make_mesh(4)).to_bmsparse()
    a2 = coo_to_bmsparse(rows, cols, (vals * 2).astype(np.float32),
                         (256, 256))
    c_ref = spgemm(a2, bt)
    for x, y in zip(c_ref.generate_coo(), c_sh.generate_coo()):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


@needs_8
def test_sharded_spmv_halo_exchange():
    """Halo exchange (two neighbour ppermutes instead of the full v
    all-gather) must be plan-feasible for banded structure and match the
    all-gather path exactly."""
    from bmsparse.parallel.plan import prepare_sharded
    from bmsparse.parallel.spmv import sharded_spmv_prepared

    n = 2048
    r1 = np.repeat(np.arange(n), 5)
    c1 = np.clip(r1 + np.tile(np.arange(-2, 3), n), 0, n - 1)
    key = np.unique(r1 * n + c1)
    rows, cols = np.divmod(key, n)
    vals = np.random.default_rng(21).standard_normal(
        len(rows)).astype(np.float32)
    m = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                        vals, (n, n))
    mesh = make_mesh(8)
    spp = prepare_sharded(partition(m, 8, align=16))
    assert spp.halo is not None, "banded window must be halo-feasible"
    v = np.random.default_rng(22).standard_normal(n).astype(np.float32)
    u_halo = np.asarray(sharded_spmv_prepared(
        spp, jnp.asarray(v), mesh, exchange="halo"))
    u_ag = np.asarray(sharded_spmv_prepared(
        spp, jnp.asarray(v), mesh, exchange="allgather"))
    ref = sp.csr_matrix((vals, (rows, cols)), shape=(n, n)) @ v
    np.testing.assert_allclose(u_halo, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u_halo, u_ag, rtol=1e-6, atol=1e-6)


@needs_8
def test_sharded_product_skew_fallback():
    """Dense-row (hub) structure makes every shard need most of B; the
    padded selective exchange would then move at least as much as an
    all-gather, and the planner must fall back — with wire-true byte
    accounting (padding charged) either way."""
    from bmsparse.ops.spgemm import spgemm
    from bmsparse.parallel.product import (
        prepare_sharded_product, sharded_multiply,
    )

    n = 512
    rng = np.random.default_rng(77)
    # every 64th row fully dense -> every shard depends on all B rows
    dense_rows = np.arange(0, n, 64)
    r1 = np.concatenate([np.full((n,), dr) for dr in dense_rows]
                        + [np.arange(n)])
    c1 = np.concatenate([np.arange(n)] * len(dense_rows)
                        + [np.arange(n)])
    key = np.unique(r1.astype(np.int64) * n + c1)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    a = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                        vals, (n, n))
    bt = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                         vals, (n, n), transposed=True)
    sa, sb = partition(a, 8, align=16), partition(bt, 8, align=16)
    spp = prepare_sharded_product(sa, sb)
    assert spp.exchange == "allgather"
    assert spp.comm_bytes_selective >= spp.comm_bytes_allgather
    assert spp.comm_bytes_useful <= spp.comm_bytes_selective
    assert spp.plan_seconds > 0
    c_ref = spgemm(a, bt)
    c_sh = sharded_multiply(spp, make_mesh(8)).to_bmsparse()
    for x, y in zip(c_ref.generate_coo(), c_sh.generate_coo()):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


def test_scaling_report_task_budget_guard():
    """The scaling report must refuse (with a recorded reason) SpGEMM
    planning whose A@A task volume exceeds the budget — a 256k-row
    webgraph estimates 131M tasks, which can neither be planned nor
    simulated on the CPU mesh (ref harness: unconditional sweep)."""
    from bmsparse.cli.scaling import (
        _estimate_spgemm_tasks, build_report,
    )

    m, ref = _make((512, 512), 0.02, seed=5)
    est = _estimate_spgemm_tasks(m)
    assert est > 0
    v = jnp.asarray(
        np.random.default_rng(0).standard_normal(512).astype(np.float32))
    rep = build_report(m, [2], v, make_mesh, iters=1,
                       spgemm_task_budget=1)
    assert rep["spgemm"] == []
    assert rep["spgemm_skipped"]["estimated_tasks"] == est
    rep2 = build_report(m, [2], v, make_mesh, iters=1)
    assert rep2["spgemm"] and "spgemm_skipped" not in rep2


def test_sharded_spmv_nonladder_depth():
    """Shard 0 has col_shift == 0, so the adaptive depth-class gate must
    also key on the pinned sell_unit — otherwise its pass-1 plan reports
    adaptive exact K values while other shards report ladder values and
    the unified forced layout crashes ('forced layout lacks a K group
    this shard needs'). Repro: 5 blocks/row (a non-ladder depth) in
    shard 0."""
    from bmsparse.parallel.plan import prepare_sharded

    n = 256
    rows = np.repeat(np.arange(n, dtype=np.int64), 5)
    # 5 well-separated block columns per scalar row -> depth exactly 5
    cols = (np.tile(np.arange(5), n) * 48 + rows % 8) % n
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = np.random.default_rng(3).standard_normal(
        rows.shape[0]).astype(np.float32)
    m = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                        vals, (n, n), backend="host")
    ref = m.to_scipy()
    sm = partition(m, 2)
    sp_plan = prepare_sharded(sm)    # must not raise
    v = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    u = np.asarray(sharded_spmv(sp_plan, jnp.asarray(v), make_mesh(2)))
    np.testing.assert_allclose(u[: n], ref @ v, rtol=1e-4, atol=1e-5)
