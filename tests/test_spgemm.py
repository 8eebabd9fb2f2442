"""SpGEMM correctness vs scipy oracle — reference semantics: C = A @ B with
B stored transposed intra-block, fp32 accumulation, structural result
(cancellations stored as explicit zeros)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from bmsparse import coo_to_bmsparse, mean_relative_error
from bmsparse.ops.spgemm import spgemm, spgemm_padded
from bmsparse.oracle.scipy_oracle import oracle_spgemm

from conftest import random_coo


def _make(shape, density, seed, transposed=False, dtype=np.float32):
    rows, cols, vals = random_coo(*shape, density=density, seed=seed, dtype=dtype)
    m = coo_to_bmsparse(rows, cols, vals, shape, transposed=transposed)
    ref = sp.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=shape)
    return m, ref


@pytest.mark.parametrize(
    "ashape,bshape,density",
    [
        ((24, 24), (24, 24), 0.15),
        ((64, 48), (48, 80), 0.08),
        ((33, 57), (57, 29), 0.12),
        ((128, 128), (128, 128), 0.03),
    ],
)
def test_spgemm_matches_scipy(ashape, bshape, density):
    a, a_ref = _make(ashape, density, seed=1)
    b, b_ref = _make(bshape, density, seed=2, transposed=True)
    c = spgemm(a, b)
    c_ref = (a_ref @ b_ref).tocsr()
    assert mean_relative_error(c, c_ref) < 1e-5


def test_spgemm_a_times_a(ragusa16):
    # The reference benchmark harness runs A*A (spgemm_run_batch.sh:15).
    coo = ragusa16
    a = coo_to_bmsparse(
        coo.row.astype(np.int32), coo.col.astype(np.int32),
        coo.data.astype(np.float32), coo.shape,
    )
    b = coo_to_bmsparse(
        coo.row.astype(np.int32), coo.col.astype(np.int32),
        coo.data.astype(np.float32), coo.shape, transposed=True,
    )
    c = spgemm(a, b)
    c_ref = (coo.tocsr() @ coo.tocsr()).tocsr()
    assert mean_relative_error(c, c_ref) < 1e-5
    # structural counts at least cover the numeric result
    assert c.nnz >= c_ref.nnz


def test_spgemm_untransposed_b():
    # B without the transposed layout must give identical results.
    a, a_ref = _make((40, 40), 0.1, seed=3)
    bt, b_ref = _make((40, 40), 0.1, seed=4, transposed=True)
    bu, _ = _make((40, 40), 0.1, seed=4, transposed=False)
    c1 = spgemm(a, bt)
    c2 = spgemm(a, bu)
    for x, y in zip(c1.generate_coo(), c2.generate_coo()):
        np.testing.assert_allclose(x, y, rtol=1e-6)
    assert mean_relative_error(c1, (a_ref @ b_ref).tocsr()) < 1e-5


def test_spgemm_structural_zeros():
    # Numeric cancellation keeps a structural entry with value 0.
    rows = np.array([0, 0, 1, 1], np.int32)
    cols = np.array([0, 1, 0, 1], np.int32)
    a_vals = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
    b_vals = np.array([1.0, 1.0, -1.0, -1.0], np.float32)
    a = coo_to_bmsparse(rows, cols, a_vals, (8, 8))
    b = coo_to_bmsparse(rows, cols, b_vals, (8, 8), transposed=True)
    c = spgemm(a, b)
    r, cc, v = c.generate_coo()
    # all four C entries structurally present, all numerically zero
    assert len(r) == 4
    np.testing.assert_allclose(v, 0.0, atol=1e-6)


def test_spgemm_empty_product():
    # A's columns never meet B's rows -> empty C
    a = coo_to_bmsparse(
        np.array([0], np.int32), np.array([0], np.int32),
        np.array([1.0], np.float32), (16, 16),
    )
    b = coo_to_bmsparse(
        np.array([8], np.int32), np.array([0], np.int32),
        np.array([1.0], np.float32), (16, 16), transposed=True,
    )
    c = spgemm(a, b)
    assert int(c.nb) == 0
    assert c.generate_coo()[0].size == 0


def test_spgemm_padded_matches_host_path():
    a, a_ref = _make((64, 64), 0.08, seed=5)
    b, b_ref = _make((64, 64), 0.08, seed=6, transposed=True)
    c = spgemm_padded(a, b, max_tasks=4096)
    c_ref = (a_ref @ b_ref).tocsr()
    assert mean_relative_error(c, c_ref) < 1e-5


def test_spgemm_padded_operands():
    a, a_ref = _make((48, 48), 0.1, seed=7)
    b, b_ref = _make((48, 48), 0.1, seed=8, transposed=True)
    ap = a.pad_to(a.nb_pad + 11, a.nnz_pad + 3)
    bp = b.pad_to(b.nb_pad + 5, b.nnz_pad + 9)
    c = spgemm(ap, bp)
    assert mean_relative_error(c, (a_ref @ b_ref).tocsr()) < 1e-5


def test_spgemm_bf16_inputs_f32_accum():
    # reference numeric regime: fp16 inputs, fp32 accumulate (SPGEMM.cu:51)
    a, a_ref = _make((64, 64), 0.1, seed=9, dtype=np.float32)
    b, b_ref = _make((64, 64), 0.1, seed=10, transposed=True)
    c = spgemm(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16))
    assert c.values.dtype == jnp.float32
    assert mean_relative_error(c, (a_ref @ b_ref).tocsr()) < 2e-2


def test_oracle_spgemm(ragusa16):
    c = oracle_spgemm(ragusa16, ragusa16)
    ref = ragusa16.tocsr() @ ragusa16.tocsr()
    assert (abs(c - ref) > 1e-8).nnz == 0


def test_spgemm_verbose_phase_labels(capsys):
    a, _ = _make((24, 24), 0.2, seed=11)
    b, _ = _make((24, 24), 0.2, seed=12, transposed=True)
    spgemm(a, b, verbose=True)
    out = capsys.readouterr().out
    assert "Task list size:" in out
    assert "Bmp reduction:" in out
    assert "Toda F:" in out


def test_spgemm_prepared_operands():
    # Prepared operands reuse decompressed tiles across calls
    from bmsparse.ops.plan import prepare

    rows, cols, vals = random_coo(96, 96, density=0.1, seed=17)
    a = coo_to_bmsparse(rows, cols, vals, (96, 96))
    bt = coo_to_bmsparse(rows, cols, vals, (96, 96), transposed=True)
    pa, pb = prepare(a), prepare(bt)
    c1 = spgemm(pa, pb)
    c2 = spgemm(a, bt)
    np.testing.assert_array_equal(np.asarray(c1.brow), np.asarray(c2.brow))
    np.testing.assert_allclose(
        np.asarray(c1.values)[: c1.nnz], np.asarray(c2.values)[: c2.nnz]
    )
    ref = sp.csr_matrix((vals, (rows, cols)), shape=(96, 96))
    assert c1.compare((ref @ ref).tocoo()) < 1e-5


def test_spgemm_result_feeds_spmv_and_spgemm():
    # C must be a fully valid container: usable as an operand downstream
    from bmsparse.ops.spmv import spmv
    from bmsparse.ops.plan import prepare

    rows, cols, vals = random_coo(64, 64, density=0.12, seed=23)
    a = coo_to_bmsparse(rows, cols, vals, (64, 64))
    bt = coo_to_bmsparse(rows, cols, vals, (64, 64), transposed=True)
    c = spgemm(a, bt)
    v = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    u = np.asarray(spmv(prepare(c), jnp.asarray(v)))
    ref = sp.csr_matrix((vals, (rows, cols)), shape=(64, 64))
    np.testing.assert_allclose(
        u, (ref @ ref) @ v, rtol=1e-3, atol=1e-4
    )
    # C @ B again (A^3)
    c2 = spgemm(c, bt)
    assert c2.compare((ref @ ref @ ref).tocoo()) < 1e-4


@pytest.mark.parametrize("impl", ["sell", "pallas", "xla"])
def test_spgemm_impl_variants(impl, monkeypatch):
    """Every numeric impl (the tc_version analogue) computes the same C
    (ref dispatch: src/bmSparse_SPGEMM.cu:1132-1155). The Triton kernel
    (impl="pallas") runs in the Pallas interpreter here."""
    import functools

    from bmsparse.ops.pallas import spgemm_kernel as sk

    monkeypatch.setattr(sk, "numeric_sell_triton", functools.partial(
        sk.numeric_sell_triton, interpret=True))
    a, a_ref = _make((160, 160), 0.05, seed=31)
    b, b_ref = _make((160, 160), 0.05, seed=32, transposed=True)
    c = spgemm(a, b, impl=impl)
    assert c.compare((a_ref @ b_ref).tocoo()) < 1e-5


def test_spgemm_impl_rejects_unknown():
    a, _ = _make((24, 24), 0.1, seed=33)
    b, _ = _make((24, 24), 0.1, seed=34, transposed=True)
    with pytest.raises(ValueError):
        spgemm(a, b, impl="wmma")


def test_prepare_product_cached_multiply():
    """prepare_product: one-time plan, device-only numeric per call;
    matches spgemm() and tracks operand VALUE updates."""
    from bmsparse.ops.product import prepare_product

    rows, cols, vals = random_coo(128, 128, density=0.05, seed=41)
    a = coo_to_bmsparse(rows, cols, vals, (128, 128))
    bt = coo_to_bmsparse(rows, cols, vals, (128, 128), transposed=True)
    pp = prepare_product(a, bt)
    c = pp()
    ref = sp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                        shape=(128, 128))
    assert c.compare((ref @ ref).tocoo()) < 1e-5
    assert pp.num_c_nnz == c.nnz

    # same structure, new values
    vals2 = (vals * 2.0).astype(np.float32)
    a2 = coo_to_bmsparse(rows, cols, vals2, (128, 128))
    c2 = pp(a=a2)
    ref2 = sp.csr_matrix((vals2.astype(np.float64), (rows, cols)),
                         shape=(128, 128))
    assert c2.compare((ref2 @ ref).tocoo()) < 1e-5

    # A^3 chain through the cache: structure of (A @ B) differs -> the
    # cached plan only serves the original structure
    with pytest.raises(ValueError):
        pp(a=coo_to_bmsparse(rows[:4], cols[:4], vals[:4], (128, 128)))


def _banded(n, band, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), band)
    offs = rng.integers(-band // 2, band // 2 + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    a = coo_to_bmsparse(
        rows.astype(np.int32), cols.astype(np.int32), vals, (n, n),
        backend="host")
    sco = a.to_scipy().tocoo()
    bt = coo_to_bmsparse(
        sco.row.astype(np.int32), sco.col.astype(np.int32),
        sco.data.astype(np.float32), (n, n), transposed=True,
        backend="host")
    return a, bt


def test_spgemm_windowed_gathers(monkeypatch):
    """The chunk-permuted windowed numeric path (plan-time windows engage
    for large operand tables; forced on here at small scale) must be
    bit-equivalent in routing to the full-table path."""
    import bmsparse.ops.spgemm as sg
    from bmsparse.ops.product import prepare_product

    a, bt = _banded(16384, 12, seed=21)
    ref = (a.to_scipy() @ a.to_scipy()).tocsr()

    monkeypatch.setattr(sg, "_WIN_TABLE_MIN_ROWS", 8)
    monkeypatch.setattr(sg, "_SELL_SLAB", 2)
    pp = prepare_product(a, bt)
    assert any(wa or wb for wa, wb in pp.plan.win), (
        "window policy never engaged — the test lost its subject")
    # class-aligned sigma padding regression: on banded structure EVERY
    # multi-chunk K-group must engage both-side windows — before the
    # fix, the chunk straddling each sigma count-class boundary spanned
    # the whole operand table and disabled its group's windows
    # (measured: band2M k=3/k=2 and fem1M got win=(0,0))
    for (kg, c0, c1), (wa, wb) in zip(pp.plan.groups, pp.plan.win):
        if c1 - c0 >= 2:
            assert wa > 0 and wb > 0, (
                f"group k={kg} ch={c1-c0} lost its windows: {(wa, wb)}")
    c = pp()
    diff = abs(c.to_scipy().tocsr() - ref)
    assert (diff.max() if diff.nnz else 0.0) < 1e-3


def test_spgemm_compress_fold_vs_scatter(monkeypatch):
    """Gather-fold compress must agree with the scatter path on the same
    plan."""
    import bmsparse.ops.spgemm as sg
    from bmsparse.ops.product import prepare_product

    from bmsparse import set_config

    a, bt = _banded(8192, 10, seed=22)
    ref = (a.to_scipy() @ a.to_scipy()).tocsr()
    set_config(spgemm_compress="fold")   # fold is opt-in since round 4
    try:
        pp_fold = prepare_product(a, bt)
        assert pp_fold.plan.compress_mode == "fold"
        c1 = pp_fold(a, bt)
    finally:
        set_config(spgemm_compress="auto")
    pp_sc = prepare_product(a, bt)
    assert pp_sc.plan.compress_mode == "scatter"
    c2 = pp_sc(a, bt)
    np.testing.assert_allclose(
        np.asarray(c1.values)[: c1.nnz], np.asarray(c2.values)[: c2.nnz],
        rtol=1e-6)
    diff = abs(c1.to_scipy().tocsr() - ref)
    assert (diff.max() if diff.nnz else 0.0) < 1e-3


def test_spgemm_two_sync_plan_counts():
    """_plan_product performs exactly two device->host syncs (the task
    total and the plan packet) — the reference's two-memcpy discipline
    (ref: src/bmSparse_SPGEMM.cu:1095,1106)."""
    import bmsparse.ops.spgemm as sg
    from bmsparse.utils.timing import PhaseTimer

    a, bt = _banded(2048, 8, seed=23)
    p = sg._plan_product(a, bt, None, None, PhaseTimer(enabled=False), False)
    # structural evidence: the plan exposes everything numeric needs
    # without further syncs — all remaining fields are device arrays or
    # host statics derived from the packet
    assert isinstance(p.num_tasks, int)
    assert isinstance(p.num_alive, int)
    assert isinstance(p.num_c_blocks, int)
    assert isinstance(p.jmax, int)
    assert p.compress_mode in ("fold", "scatter")
    assert len(p.win) == len(p.groups) == len(p.win_starts)


def _diag_pair(n, diags, seed=0):
    """Banded A from whole diagonals, and its transposed-layout copy."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(max(0, -d), min(n, n - d))
                           for d in diags])
    cols = np.concatenate([np.arange(max(0, -d), min(n, n - d)) + d
                           for d in diags])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    a = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32), vals,
                        (n, n), backend="host")
    bt = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32), vals,
                         (n, n), transposed=True, backend="host")
    return a, bt


def _scattered_pair(n, per_row, seed):
    rng = np.random.default_rng(seed)
    flat = rng.choice(n * n, size=n * per_row, replace=False)
    r, c = np.divmod(flat, n)
    v = rng.standard_normal(len(r)).astype(np.float32)
    a = coo_to_bmsparse(r.astype(np.int32), c.astype(np.int32), v, (n, n),
                        backend="host")
    bt = coo_to_bmsparse(r.astype(np.int32), c.astype(np.int32), v, (n, n),
                         transposed=True, backend="host")
    return a, bt


_STRUCTURES = {
    "banded": lambda: _diag_pair(4096, [0, 1, -1, 8, -8, 17]),
    "scattered": lambda: _scattered_pair(8192, 2, seed=3),
    "bf16": lambda: tuple(
        x.astype(jnp.bfloat16) for x in _diag_pair(2048, [0, 2, -3, 9], 7)),
    "cached": lambda: _diag_pair(2048, [0, 1, -1, 5], seed=11),
}


@pytest.mark.parametrize("structure,impl", [
    (s, i) for s in ("banded", "scattered", "bf16") for i in ("sell", "xla")
] + [("cached", "sell")])
def test_spgemm_structures_match_scipy(structure, impl):
    """Banded, scattered, bf16-tile and cached-product A@A through the
    plain XLA numeric paths against scipy in float64 (bf16: against the
    bf16-rounded operands)."""
    from bmsparse.ops.product import prepare_product

    a, bt = _STRUCTURES[structure]()
    sa = a.to_scipy().tocsr()
    ref = (sa @ sa).tocsr()
    if structure == "cached":
        pp = prepare_product(a, bt, impl=impl)
        got = pp().to_scipy().tocsr()
        got2 = pp(a=a).to_scipy().tocsr()
        assert abs(got2 - got).max() == 0
    else:
        got = spgemm(a, bt, impl=impl).to_scipy().tocsr()
    assert got.nnz >= ref.nnz
    d = abs(got - ref)
    assert (d.max() if d.nnz else 0.0) < 1e-4 * max(abs(ref).max(), 1)
