"""SpMV correctness vs scipy oracle (reference semantics: u = A @ v,
v initialized to ones in the reference driver, ref: src/bmSparse_SPMV.cu:279)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from bmsparse import CSRMatrix, coo_to_bmsparse, csr_spmv, spmv
from bmsparse.oracle.scipy_oracle import oracle_spmv

from conftest import random_coo


@pytest.mark.parametrize(
    "shape,density",
    [((24, 24), 0.15), ((64, 64), 0.1), ((100, 52), 0.07), ((333, 217), 0.03)],
)
def test_spmv_matches_scipy(shape, density):
    rows, cols, vals = random_coo(*shape, density=density, seed=hash(shape) % 997)
    ref = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    m = coo_to_bmsparse(rows, cols, vals, shape)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(shape[1]).astype(np.float32)
    u = np.asarray(spmv(m, jnp.asarray(v)))
    np.testing.assert_allclose(u, ref @ v, rtol=1e-4, atol=1e-5)


def test_spmv_ones_vector(ragusa16):
    m = coo_to_bmsparse(
        ragusa16.row.astype(np.int32),
        ragusa16.col.astype(np.int32),
        ragusa16.data.astype(np.float32),
        ragusa16.shape,
    )
    v = jnp.ones((ragusa16.shape[1],), jnp.float32)
    u = np.asarray(spmv(m, v))
    np.testing.assert_allclose(u, ragusa16 @ np.ones(ragusa16.shape[1]), rtol=1e-5)


def test_spmv_padded_equals_unpadded():
    rows, cols, vals = random_coo(80, 80, density=0.05, seed=21)
    m = coo_to_bmsparse(rows, cols, vals, (80, 80))
    v = jnp.asarray(np.random.default_rng(2).standard_normal(80), jnp.float32)
    u1 = np.asarray(spmv(m, v))
    u2 = np.asarray(spmv(m.pad_to(m.nb_pad + 33, m.nnz_pad + 8), v))
    np.testing.assert_allclose(u1, u2, rtol=1e-6)


def test_spmv_bf16():
    rows, cols, vals = random_coo(64, 64, density=0.1, seed=23)
    ref = sp.csr_matrix((vals, (rows, cols)), shape=(64, 64))
    m = coo_to_bmsparse(rows, cols, vals.astype(jnp.bfloat16), (64, 64))
    v = np.ones(64, np.float32)
    u = np.asarray(spmv(m, jnp.asarray(v, jnp.bfloat16))).astype(np.float32)
    np.testing.assert_allclose(u, ref @ v, rtol=0.05, atol=0.1)


@pytest.mark.parametrize(
    "shape,density",
    [((24, 24), 0.15), ((64, 64), 0.1), ((100, 52), 0.07), ((333, 217), 0.03)],
)
def test_spmv_prepared_matches(shape, density):
    # tiered plan (window + remainder) must agree with the direct path
    from bmsparse.ops.plan import prepare

    rows, cols, vals = random_coo(*shape, density=density, seed=hash(shape) % 991)
    ref = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    m = coo_to_bmsparse(rows, cols, vals, shape)
    p = prepare(m)
    v = np.random.default_rng(7).standard_normal(shape[1]).astype(np.float32)
    u = np.asarray(spmv(p, jnp.asarray(v)))
    np.testing.assert_allclose(u, ref @ v, rtol=1e-4, atol=1e-5)


def test_spmv_prepared_banded():
    # strongly banded matrix: most nnz should land in the DIA tier
    from bmsparse.ops.plan import prepare

    n = 512
    rng = np.random.default_rng(9)
    rows = np.repeat(np.arange(n), 3)
    cols = np.clip(rows + rng.integers(-4, 5, size=rows.shape[0]), 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    ref = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    m = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32), vals, (n, n))
    p = prepare(m)
    assert len(p.dia_offsets) > 0
    v = rng.standard_normal(n).astype(np.float32)
    u = np.asarray(spmv(p, jnp.asarray(v)))
    np.testing.assert_allclose(u, ref @ v, rtol=1e-4, atol=1e-5)


def test_spmv_prepared_empty_and_tiny():
    # empty matrix and single-block-row matrices go through the plan path
    from bmsparse.ops.plan import prepare

    e = coo_to_bmsparse(
        np.empty(0, np.int32), np.empty(0, np.int32),
        np.empty(0, np.float32), (16, 16),
    )
    u = np.asarray(spmv(prepare(e), jnp.ones(16)))
    assert u.shape == (16,) and np.all(u == 0)

    b = coo_to_bmsparse(
        np.zeros(5, np.int32), (np.arange(5, dtype=np.int32) * 7),
        np.ones(5, np.float32), (1, 40),
    )
    u = np.asarray(spmv(prepare(b), jnp.ones(40)))
    assert u.shape == (1,) and u[0] == 5.0


def test_csr_spmv(ragusa16):
    csr = CSRMatrix.from_scipy(ragusa16.astype(np.float32))
    v = np.random.default_rng(3).standard_normal(ragusa16.shape[1]).astype(np.float32)
    u = np.asarray(csr_spmv(csr, jnp.asarray(v)))
    np.testing.assert_allclose(u, ragusa16 @ v, rtol=1e-4, atol=1e-5)


def test_oracle_spmv_runs(ragusa16):
    v = np.ones(ragusa16.shape[1], np.float32)
    u = oracle_spmv(ragusa16, v)
    np.testing.assert_allclose(u, ragusa16 @ v)


def test_spmv_rejects_transposed():
    rows, cols, vals = random_coo(16, 16, density=0.2, seed=4)
    m = coo_to_bmsparse(rows, cols, vals, (16, 16), transposed=True)
    with pytest.raises(ValueError):
        spmv(m, jnp.ones(16, jnp.float32))


def test_real_structure_families_spmv():
    """The SuiteSparse-stand-in generators (utils/testmats.py) must be
    well-formed and run the tiered SpMV correctly; log the planner tier
    choice for each family."""
    import scipy.sparse as ssp

    from bmsparse import coo_to_bmsparse
    from bmsparse.ops.plan import prepare
    from bmsparse.ops.spmv import spmv
    from bmsparse.utils import testmats as tm

    for name, gen in [
        ("fem2d", lambda: tm.fem2d(64, seed=7)),
        ("roadnet", lambda: tm.roadnet(4096, seed=8)),
        ("webgraph", lambda: tm.webgraph(4096, avg_deg=6, seed=9)),
    ]:
        rows, cols, vals, shape = gen()
        assert rows.shape == cols.shape == vals.shape
        m = coo_to_bmsparse(rows, cols, vals, shape, backend="host")
        p = prepare(m)
        v = np.random.default_rng(3).standard_normal(
            shape[1]).astype(np.float32)
        u = np.asarray(spmv(p, jnp.asarray(v)))
        ref = ssp.csr_matrix((vals, (rows, cols)), shape=shape) @ v
        np.testing.assert_allclose(u, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_sell_win64_superslots_match_blocks():
    """Super-slot SELL (cw=64: one gather per 64-scalar column window,
    merging a row's clustered blocks) must agree with the per-block
    (cw=8) plan, and the auto policy must pick cw=64 only when the
    merge factor justifies it."""
    from bmsparse.ops.plan import prepare

    rng = np.random.default_rng(31)
    # clustered-column structure (road-like): blocks of each row share
    # 64-scalar windows -> the auto policy should engage super-slots
    n = 8192
    deg = 6
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    centers = rng.integers(0, n, size=n)
    cols = np.clip(centers[rows] + rng.integers(0, 48, size=rows.shape[0]),
                   0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    m = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),
                        vals, (n, n), backend="host")
    v = rng.standard_normal(n).astype(np.float32)
    ref = m.to_scipy() @ v

    p_auto = prepare(m)
    p_blk = prepare(m, sell_unit=8)
    p_win = prepare(m, sell_unit=64)
    assert p_win.sell_dense and p_win.sell_dense[0].shape[0] == 64
    assert p_blk.sell_dense[0].shape[0] == 8
    # fewer gather indices under super-slots
    assert sum(b.size for b in p_win.sell_bcol) < sum(
        b.size for b in p_blk.sell_bcol)
    for p in (p_auto, p_blk, p_win):
        u = spmv(p, v)
        np.testing.assert_allclose(np.asarray(u), ref, rtol=1e-4,
                                   atol=1e-4)
    # scattered columns (web-like): the policy must keep cw=8
    nnz = n * 4
    flat = rng.choice(n * n, size=nnz, replace=False)
    r2, c2 = np.divmod(flat, n)
    v2 = rng.standard_normal(nnz).astype(np.float32)
    order = np.lexsort((c2, r2))
    m2 = coo_to_bmsparse(r2[order].astype(np.int32),
                         c2[order].astype(np.int32), v2[order], (n, n),
                         backend="host")
    p2 = prepare(m2)
    if p2.sell_dense:
        assert p2.sell_dense[0].shape[0] == 8
    u2 = spmv(p2, np.asarray(v))
    np.testing.assert_allclose(np.asarray(u2), m2.to_scipy() @ v,
                               rtol=1e-4, atol=1e-4)


def test_adaptive_k_buckets_dp():
    """The partition DP must (a) return exact depths when distinct chunk
    maxima fit the group budget, (b) never pad below a chunk's max,
    (c) beat or match the fixed geometric ladder on a skewed histogram."""
    from bmsparse.ops.plan import (
        MAX_SELL_GROUPS, _adaptive_k_buckets, _bucket_k,
    )

    rng = np.random.default_rng(7)
    # few distinct values -> exact
    cm = np.array([17, 9, 9, 5, 5, 5, 2, 1], np.int64)
    np.testing.assert_array_equal(_adaptive_k_buckets(cm), cm)
    # skewed power-law histogram -> bounded classes, valid, no worse
    # than the fixed ladder
    cm = np.sort(rng.zipf(1.5, size=4000).clip(1, 300))[::-1].astype(
        np.int64)
    pad = _adaptive_k_buckets(cm)
    assert np.all(pad >= cm)
    assert len(np.unique(pad)) <= MAX_SELL_GROUPS
    fixed = np.array([_bucket_k(int(k)) for k in cm], np.int64)
    assert pad.sum() <= fixed.sum()
    # non-increasing input stays non-increasing (groups contiguous)
    assert np.all(np.diff(pad) <= 0)


def _clustered_coo(n, deg, spread, seed):
    """Road-like rows: each row's columns cluster near a random center."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    centers = rng.integers(0, n, size=n)
    cols = np.clip(centers[rows] + rng.integers(0, spread, size=rows.shape[0]),
                   0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    return rows, cols


def _road_like_coo(n, seed):
    """Locally clustered rows plus ~1% far 'highway' links."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    cols = np.clip(rows + rng.integers(-40, 41, size=rows.shape[0]), 0, n - 1)
    hs, hd = rng.integers(0, n, n // 100), rng.integers(0, n, n // 100)
    key = np.unique(np.concatenate([rows, hs]) * n
                    + np.concatenate([cols, hd]))
    return np.divmod(key, n)


def _uniform_coo(n, per_row, seed):
    rng = np.random.default_rng(seed)
    flat = rng.choice(n * n, size=n * per_row, replace=False)
    return np.divmod(flat, n)


def _web_coo(n, deg, seed):
    from bmsparse.utils.testmats import webgraph

    rows, cols, _, _ = webgraph(n, avg_deg=deg, seed=seed)
    return rows, cols


_SPMV_STRUCTURES = {
    "clustered": (4096, lambda: _clustered_coo(4096, 6, 48, 31)),
    "clustered_wide": (4096, lambda: _clustered_coo(4096, 5, 90, 13)),
    "scattered": (4096, lambda: _uniform_coo(4096, 4, 3)),
    "tiny": (16, lambda: (np.array([0, 1, 5, 9]), np.array([3, 9, 1, 14]))),
    "bf16": (1024, lambda: _clustered_coo(1024, 4, 30, 5)),
    "road_like": (32768, lambda: _road_like_coo(32768, 11)),
    "web4k": (4096, lambda: _web_coo(4096, 6, 0)),
    "web16k": (16384, lambda: _web_coo(16384, 8, 1)),
}


@pytest.mark.parametrize("structure", sorted(_SPMV_STRUCTURES))
def test_spmv_structures_match_scipy(structure):
    """Clustered, scattered, tiny, road-like and web structures through
    prepare() + the block tiers (stream tier off) against scipy in
    float64; the bf16 plan against its bf16-rounded values."""
    from bmsparse.ops.plan import prepare

    n, gen = _SPMV_STRUCTURES[structure]
    rows, cols = gen()
    rng = np.random.default_rng(7)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    m = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32), vals,
                        (n, n), backend="host")
    dtype = jnp.bfloat16 if structure == "bf16" else None
    p = prepare(m, dtype=dtype, stream="off")
    assert p.stream is None
    if dtype is not None:
        vals = np.asarray(jnp.asarray(vals, dtype).astype(jnp.float32))
    v = rng.standard_normal(n).astype(np.float32)
    ref = sp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                        shape=(n, n)) @ v
    u = np.asarray(spmv(p, jnp.asarray(v)))
    np.testing.assert_allclose(u, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_sell_groups_one_per_depth():
    """The SELL builder forms exactly one group per padded depth K, in
    descending order, and every chunk of a group has that depth."""
    from bmsparse.ops.plan import _build_sell_tier

    nbr, ncu, cw = 512, 4096, 8
    rng = np.random.default_rng(0)
    # 1..4 slots per block row -> several K classes
    per_row = rng.integers(1, 5, nbr)
    ubr = np.repeat(np.arange(nbr, dtype=np.int64), per_row)
    ubc = np.concatenate([rng.choice(ncu, k, replace=False)
                          for k in per_row]).astype(np.int64)
    key = np.unique(ubr * ncu + ubc)
    ubr, ubc = np.divmod(key, ncu)
    vals = rng.standard_normal(len(ubr)).astype(np.float32)
    dense, bcol, ks, og, rows_total = _build_sell_tier(
        np.arange(len(ubr)), ubr, ubc, np.zeros(len(ubr), np.int64), vals,
        np.arange(len(ubr)), nbr, ncu, cw, np.dtype(np.float32))
    assert list(ks) == sorted(set(ks), reverse=True)
    for d, b, k in zip(dense, bcol, ks):
        assert d.shape[2] == k and b.size == d.shape[1] * k * 128
    assert rows_total == sum(d.shape[1] for d in dense) * 128
    assert og.shape == (nbr,) and (og < rows_total).all()
