"""Reference-quirk parity: the reference carries latent correctness traps
(SURVEY.md §5 "known correctness assumptions"); this build implements the
*intended* semantics. These tests pin down exactly the cases where the
reference would misbehave:

  1. empty block-rows in the indexed operand (ref indexes `pos[col]` /
     `first_blocks[blockIdx.x]` by absolute block-row but compacts empty
     rows out — src/bmSparse_SPGEMM.cu:134, src/bmSparse_SPMV.cu:92);
  2. non-square SpMV (ref sizes its grid with num_cols where num_rows is
     meant — src/bmSparse_SPMV.cu:217,220);
  3. segmented sort equivalence (bb_segsort is unstable and segment-local;
     ours must order globally by (segment, key)).
"""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from bmsparse import coo_to_bmsparse
from bmsparse.ops.plan import prepare
from bmsparse.ops.spgemm import spgemm
from bmsparse.ops.spmv import spmv


def _coo(rows, cols, vals, shape, **kw):
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float32)
    order = np.lexsort((cols, rows))
    return coo_to_bmsparse(rows[order], cols[order], vals[order], shape, **kw)


def test_spmv_empty_block_rows():
    # rows 8..23 (block-rows 1 and 2) completely empty
    rows = [0, 1, 25, 30, 31]
    cols = [5, 11, 2, 30, 17]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    m = _coo(rows, cols, vals, (32, 32))
    v = np.arange(32, dtype=np.float32)
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(32, 32)) @ v
    u = np.asarray(spmv(prepare(m), jnp.asarray(v)))
    np.testing.assert_allclose(u, ref, rtol=1e-6)
    assert np.all(u[8:24] == 0)


def test_spgemm_empty_block_rows_in_b():
    # B has empty block-rows that A's block-columns point past
    rng = np.random.default_rng(0)
    ar, ac = [0, 3, 9, 17], [2, 30, 12, 28]
    av = rng.standard_normal(4).astype(np.float32)
    br_, bc_ = [2, 12, 28, 30, 31], [0, 4, 9, 1, 31]
    bv = rng.standard_normal(5).astype(np.float32)
    a = _coo(ar, ac, av, (24, 32))
    b = _coo(br_, bc_, bv, (32, 32), transposed=True)
    c = spgemm(a, b)
    ref = (
        sp.coo_matrix((av, (ar, ac)), shape=(24, 32)).tocsr()
        @ sp.coo_matrix((bv, (br_, bc_)), shape=(32, 32)).tocsr()
    ).tocoo()
    assert c.compare(ref) < 1e-6


def test_spmv_rectangular_tall_and_wide():
    # the reference's grid sizing is only correct for square matrices;
    # both aspect ratios must work here
    rng = np.random.default_rng(7)
    for shape in [(160, 24), (24, 160), (7, 300), (300, 7)]:
        m_, n_ = shape
        nnz = max(1, m_ * n_ // 10)
        flat = rng.choice(m_ * n_, size=nnz, replace=False)
        rows, cols = np.divmod(flat, n_)
        vals = rng.standard_normal(nnz).astype(np.float32)
        m = _coo(rows, cols, vals, shape)
        v = rng.standard_normal(n_).astype(np.float32)
        ref = sp.coo_matrix((vals, (rows, cols)), shape=shape) @ v
        u = np.asarray(spmv(prepare(m), jnp.asarray(v)))
        assert u.shape == (m_,)
        np.testing.assert_allclose(u, ref, rtol=1e-4, atol=1e-5)


def test_segmented_sort_matches_reference_semantics():
    from bmsparse.ops.segsort import segmented_sort, sort_by_key

    rng = np.random.default_rng(1)
    seg = jnp.asarray(rng.integers(0, 50, 4000).astype(np.int32))
    key = jnp.asarray(rng.integers(0, 10**6, 4000).astype(np.int32))
    val = jnp.asarray(rng.standard_normal(4000).astype(np.float32))
    s, k, v = segmented_sort(seg, key, val, num_keys=1)
    s, k = np.asarray(s), np.asarray(k)
    assert np.all(np.diff(s) >= 0)
    # within each segment, keys ascend
    brk = np.flatnonzero(np.diff(s) != 0) + 1
    for lo, hi in zip(np.r_[0, brk], np.r_[brk, len(s)]):
        assert np.all(np.diff(k[lo:hi]) >= 0)
    # value alignment preserved
    order = np.lexsort((np.asarray(key), np.asarray(seg)))
    np.testing.assert_allclose(np.asarray(v), np.asarray(val)[order])

    k2, v2 = sort_by_key(key, val, num_keys=1)
    np.testing.assert_array_equal(np.asarray(k2), np.sort(np.asarray(key)))


def test_spgemm_row_of_c_larger_than_64_tasks():
    # a C block accumulating >64 tasks stresses the K-padded numeric
    # grouping (the reference's TASK_BUFFER chunking analogue)
    rng = np.random.default_rng(2)
    # A = 8x800 dense-ish row strip, B = 800x8 column strip -> C is one
    # block with 100 tasks
    ar = np.repeat(np.arange(8), 100)
    ac = np.tile(np.arange(100) * 8, 8)
    av = rng.standard_normal(800).astype(np.float32)
    br_ = np.arange(100) * 8
    bc_ = np.zeros(100, np.int64)
    bv = rng.standard_normal(100).astype(np.float32)
    a = _coo(ar, ac, av, (8, 800))
    b = _coo(br_, bc_, bv, (800, 8), transposed=True)
    c = spgemm(a, b)
    ref = (
        sp.coo_matrix((av, (ar, ac)), shape=(8, 800)).tocsr()
        @ sp.coo_matrix((bv, (br_, bc_)), shape=(800, 8)).tocsr()
    ).tocoo()
    assert c.compare(ref) < 1e-5
