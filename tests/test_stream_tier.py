"""Stream tier (ops/route.py): the gather-free scattered-structure SpMV.

Covers the plan-time routing network construction (window packing,
two gather stages, residue fallback), end-to-end numerical correctness
vs scipy, and the routing cost model.

Reference parity: this tier plays the role of the reference's gather
SpMV kernel on locality-free matrices (ref: src/bmSparse_SPMV.cu:84-189).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from bmsparse.ops.route import (
    K_CAP, S2, S3, StreamPlan, build_stream_plan, stream_apply,
)


def _web_coo(n, avg_deg, seed):
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    src = rng.integers(0, n, m)
    dst = np.minimum((rng.random(m) ** 3.0) * n, n - 1).astype(np.int64)
    dst = rng.permutation(n)[dst]
    key = np.unique(src * n + dst)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals


@pytest.mark.parametrize("n,deg,seed", [(4096, 6, 0), (16384, 8, 1)])
def test_stream_matches_scipy(n, deg, seed):
    rows, cols, vals = _web_coo(n, deg, seed)
    # keep rows under K_CAP (the caller's contract)
    cnt = np.bincount(rows, minlength=n)
    keep = cnt[rows] <= K_CAP
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    p = build_stream_plan(rows, cols, vals, n, n)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(n).astype(np.float32)
    u = np.asarray(stream_apply(p, jnp.asarray(v)))
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)) @ v
    np.testing.assert_allclose(u, ref, rtol=1e-4, atol=1e-4)


def test_stream_residue_fraction_small():
    """The slack-based router must place ~all slots in the network; the
    XLA fallback is for the tail only."""
    rows, cols, vals = _web_coo(16384, 8, 3)
    cnt = np.bincount(rows, minlength=16384)
    keep = cnt[rows] <= K_CAP
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    p = build_stream_plan(rows, cols, vals, 16384, 16384)
    frac = p.res_rows.shape[0] / max(len(rows), 1)
    assert frac < 0.02, f"residue fraction {frac:.4f}"


def test_stream_empty_and_tiny():
    p = build_stream_plan(
        np.array([0, 5], np.int32), np.array([3, 100], np.int32),
        np.array([2.0, -1.0], np.float32), 256, 256)
    v = np.arange(256, dtype=np.float32)
    u = np.asarray(stream_apply(p, jnp.asarray(v)))
    ref = np.zeros(256, np.float32)
    ref[0] = 2.0 * v[3]
    ref[5] = -1.0 * v[100]
    np.testing.assert_allclose(u, ref, rtol=1e-6)


def test_stream_dense_rows_rejected():
    rows = np.zeros(K_CAP + 1, np.int32)
    cols = np.arange(K_CAP + 1, dtype=np.int32) * 7
    vals = np.ones(K_CAP + 1, np.float32)
    with pytest.raises(AssertionError):
        build_stream_plan(rows, cols, vals, 128, 1024)


def test_prepare_routes_webgraph_to_stream():
    """prepare() must pick the stream tier for locality-free 1-nnz-block
    structure, keep heavy rows on SELL, and stay exact end-to-end."""
    from bmsparse import coo_to_bmsparse, spmv
    from bmsparse.ops.plan import prepare

    n = 16384
    rows, cols, vals = _web_coo(n, 8, seed=5)
    # add two hub rows heavier than K_CAP so the SELL split engages
    hub = np.concatenate([
        np.full(200, 7, np.int32), np.full(150, 4000, np.int32)])
    hubc = np.arange(350, dtype=np.int32) * 45 % n
    rows = np.concatenate([rows, hub])
    cols = np.concatenate([cols, hubc])
    key = np.unique(rows.astype(np.int64) * n + cols)
    rows, cols = np.divmod(key, n)
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    m = coo_to_bmsparse(
        rows.astype(np.int32), cols.astype(np.int32), vals, (n, n),
        backend="host")
    # stream="force": the routing MODEL is exercised by
    # test_cost_model_routing below; this test checks the tier itself
    p = prepare(m, stream="force")
    assert p.stream is not None, "webgraph must route to the stream tier"
    # the heavy hub rows stay on SELL
    assert p.sell_ks, "hub rows must keep a SELL group"

    v = rng.standard_normal(n).astype(np.float32)
    ref = m.to_scipy() @ v
    u = np.asarray(spmv(p, jnp.asarray(v)))
    np.testing.assert_allclose(u, ref, rtol=1e-4, atol=1e-4)


def test_prepare_keeps_banded_off_stream():
    from bmsparse import coo_to_bmsparse
    from bmsparse.ops.plan import prepare

    n = 8192
    rng = np.random.default_rng(1)
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    cols = np.clip(rows + rng.integers(-20, 21, rows.shape[0]), 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    m = coo_to_bmsparse(
        rows.astype(np.int32), cols.astype(np.int32), vals, (n, n),
        backend="host")
    p = prepare(m)
    assert p.stream is None, "banded structure must stay on DIA/SELL"


# post-DIA remainders of the suite matrices, as prepare() sees them:
# (name, nnz, k, n_rows, nblk, nwin, routes to the stream tier)
_MEASURED_STRUCTURES = [
    ("web256k", 2_094_508, 23, 262_144, 2_078_143, 2_063_750, True),
    ("rand64k", 1_288_490, 40, 65_536, 1_276_222, 1_194_497, True),
    ("road1M", 4_014_142, 13, 1_048_576, 1_279_808, 328_858, True),
    ("blockdense1M", 20_971_520, 64, 1_048_576, 327_680, 327_661, False),
]


def test_cost_model_routing():
    """The routing model picks the tier that measured faster on the
    card for each suite structure (PERF.md: the stream tier won web,
    uniform-random and road SpMV; the block tiers won blockdense)."""
    from bmsparse.ops.plan import _block_cost_estimate
    from bmsparse.ops.route import stream_cost_estimate

    for name, nnz, k, n_rows, nblk, nwin, stream in _MEASURED_STRUCTURES:
        est_block = _block_cost_estimate(nblk, nwin, 4)
        est_stream = stream_cost_estimate(nnz, k, n_rows)
        assert (2 * est_stream < est_block) == stream, name
