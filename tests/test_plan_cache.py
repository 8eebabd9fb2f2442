"""Prepared-plan persistence and on-device dtype casts.

The bench pipeline relies on both: plans are deterministic per matrix,
so save_prepared/load_prepared must round-trip exactly, and
cast_prepared must match what prepare(m, dtype=...) would have built
(the bench's bf16 lines are produced by the cast, not a rebuild).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from bmsparse import coo_to_bmsparse
from bmsparse.io.binary import load_prepared, save_prepared
from bmsparse.ops.plan import cast_prepared, prepare
from bmsparse.ops.spmv import spmv


def _mixed_matrix(n=2048, seed=0):
    """Banded core + scattered outliers: engages DIA + SELL."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    cols = np.clip(rows + rng.integers(-3, 4, size=rows.shape[0]), 0, n - 1)
    er = rng.integers(0, n, 300)
    ec = rng.integers(0, n, 300)
    key = np.unique(
        np.concatenate([rows, er]) * n + np.concatenate([cols, ec]))
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    m = coo_to_bmsparse(
        rows.astype(np.int32), cols.astype(np.int32), vals, (n, n),
        backend="host")
    return m, rows, cols, vals


def _ref_spmv(rows, cols, vals, v, n):
    u = np.zeros(n)
    np.add.at(u, rows, vals.astype(np.float64) * v[cols])
    return u


def test_save_load_roundtrip(tmp_path):
    m, rows, cols, vals = _mixed_matrix()
    p = prepare(m)
    v = np.random.default_rng(1).standard_normal(m.num_cols).astype(
        np.float32)
    u = np.asarray(spmv(p, jnp.asarray(v)))
    path = str(tmp_path / "plan.pkl")
    save_prepared(path, p)
    p2 = load_prepared(path, m)
    assert p2 is not None
    assert p2.sell_ks == p.sell_ks
    assert p2.dia_offsets == p.dia_offsets
    u2 = np.asarray(spmv(p2, jnp.asarray(v)))
    np.testing.assert_array_equal(u, u2)


def test_save_load_stream_tier(tmp_path):
    from bmsparse.utils import testmats as tm

    rows, cols, vals, shape = tm.webgraph(4096, avg_deg=6, seed=9)
    m = coo_to_bmsparse(rows, cols, vals, shape, backend="host")
    p = prepare(m, stream="force")
    assert p.stream is not None
    v = np.random.default_rng(2).standard_normal(shape[1]).astype(
        np.float32)
    u = np.asarray(spmv(p, jnp.asarray(v)))
    path = str(tmp_path / "plan.pkl")
    save_prepared(path, p)
    p2 = load_prepared(path, m)
    u2 = np.asarray(spmv(p2, jnp.asarray(v)))
    np.testing.assert_array_equal(u, u2)


def test_load_rejects_stale_layout(tmp_path, monkeypatch):
    m, *_ = _mixed_matrix(n=256)
    p = prepare(m)
    path = str(tmp_path / "plan.pkl")
    save_prepared(path, p)
    import bmsparse.ops.plan as plan_mod

    monkeypatch.setattr(plan_mod, "PLAN_LAYOUT_VERSION", -1)
    assert load_prepared(path, m) is None


def test_cast_matches_rebuild():
    m, rows, cols, vals = _mixed_matrix(seed=3)
    p = prepare(m)
    pc = cast_prepared(p, jnp.bfloat16)
    pr = prepare(m, dtype=jnp.bfloat16)
    assert pc.plan_dtype == "bfloat16"
    assert pc.sell_ks == pr.sell_ks
    v = np.random.default_rng(4).standard_normal(m.num_cols).astype(
        np.float32)
    uc = np.asarray(spmv(pc, jnp.asarray(v)))
    ur = np.asarray(spmv(pr, jnp.asarray(v)))
    np.testing.assert_array_equal(uc, ur)
    # and the cast result is still a correct SpMV at bf16 tolerance
    u_ref = _ref_spmv(rows, cols, vals, v.astype(np.float64), m.num_rows)
    scale = np.abs(u_ref).max() + 1e-30
    assert np.abs(uc - u_ref).max() / scale < 0.02


def test_cast_noop_and_f64_drops_windows():
    import jax

    m, *_ = _mixed_matrix(seed=5)
    p = prepare(m)
    assert cast_prepared(p, jnp.float32) is p
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("x64 disabled")
    p64 = cast_prepared(p, jnp.float64)
    assert p64.plan_dtype == "float64"
    assert p64.sell_ks == p.sell_ks
    v = np.random.default_rng(6).standard_normal(m.num_cols)
    u64 = np.asarray(spmv(p64, jnp.asarray(v, jnp.float64)))
    assert u64.dtype == np.float64
