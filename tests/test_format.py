"""Format-core tests: bitmap algebra, COO<->BmSparse round trip, CSR,
binary IO — the round-trip-vs-scipy oracle strategy of SURVEY.md §4."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from bmsparse import (
    BmSparse,
    CSRMatrix,
    bmsparse_to_csr,
    coo_to_bmsparse,
    csr_to_bmsparse,
    load_bmsparse,
    mean_relative_error,
    save_bmsparse,
)
from bmsparse.format import bitmap as bm

from conftest import random_coo


# ---------------------------------------------------------------------------
# bitmap algebra
# ---------------------------------------------------------------------------
def test_expand_pack_roundtrip(rng):
    words = rng.integers(0, 2**32, size=(32, 2), dtype=np.uint32)
    hi, lo = jnp.asarray(words[:, 0]), jnp.asarray(words[:, 1])
    bits = bm.expand_bits(hi, lo)
    assert bits.shape == (32, 64)
    hi2, lo2 = bm.pack_bits(bits)
    np.testing.assert_array_equal(np.asarray(hi2), words[:, 0])
    np.testing.assert_array_equal(np.asarray(lo2), words[:, 1])


def test_bit_convention_matches_reference():
    # bit 63 - a for address a = rel_i*8 + rel_j (ref: src/bmSpMatrix.cu:96)
    hi, lo = bm.coords_to_words(jnp.array([0]), jnp.array([0]), transposed=False)
    assert int(hi[0]) == 0x80000000 and int(lo[0]) == 0  # address 0 -> bit 63 -> hi bit 31
    hi, lo = bm.coords_to_words(jnp.array([7]), jnp.array([7]), transposed=False)
    assert int(hi[0]) == 0 and int(lo[0]) == 1  # address 63 -> bit 0
    # transposed: address = rel_j*8 + rel_i (ref: src/bmSpMatrix.cu:91-95)
    hi, lo = bm.coords_to_words(jnp.array([1]), jnp.array([0]), transposed=True)
    bits = bm.expand_bits(hi, lo)
    assert int(bits[0, 1]) == 1 and int(jnp.sum(bits)) == 1


def test_popcount_and_prefix(rng):
    words = rng.integers(0, 2**32, size=(16, 2), dtype=np.uint32)
    hi, lo = jnp.asarray(words[:, 0]), jnp.asarray(words[:, 1])
    bits = np.asarray(bm.expand_bits(hi, lo))
    np.testing.assert_array_equal(
        np.asarray(bm.popcount(hi, lo)), bits.sum(axis=1)
    )
    prefix = np.asarray(bm.prefix_popcount(jnp.asarray(bits)))
    expected = np.cumsum(bits, axis=1) - bits
    np.testing.assert_array_equal(prefix, expected)


def test_bitmap_product_matches_dense(rng):
    # C(i,k) = OR_j A(i,j) & B(j,k) with B column-major (transposed storage)
    a_dense = (rng.random((8, 8)) < 0.3).astype(np.int32)
    b_dense = (rng.random((8, 8)) < 0.3).astype(np.int32)
    a_bits = jnp.asarray(a_dense.reshape(1, 64))
    b_bits = jnp.asarray(b_dense.T.reshape(1, 64))  # column-major storage
    a_hi, a_lo = bm.pack_bits(a_bits)
    b_hi, b_lo = bm.pack_bits(b_bits)
    c_hi, c_lo = bm.bitmap_product(a_hi, a_lo, b_hi, b_lo, b_transposed=True)
    c_bits = np.asarray(bm.expand_bits(c_hi, c_lo)).reshape(8, 8)
    expected = ((a_dense @ b_dense) > 0).astype(np.int32)
    np.testing.assert_array_equal(c_bits, expected)


# ---------------------------------------------------------------------------
# conversion round trips
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,density", [((24, 24), 0.15), ((100, 64), 0.05),
                                           ((9, 17), 0.3), ((256, 256), 0.02)])
@pytest.mark.parametrize("transposed", [False, True])
def test_coo_roundtrip(shape, density, transposed):
    rows, cols, vals = random_coo(*shape, density=density, seed=hash(shape) % 2**31)
    m = coo_to_bmsparse(rows, cols, vals, shape, transposed=transposed)
    r2, c2, v2 = m.generate_coo()
    ref = sp.coo_matrix((vals, (rows, cols)), shape=shape)
    got = sp.coo_matrix((v2, (r2, c2)), shape=shape)
    assert (abs(ref - got) > 1e-6).nnz == 0
    assert mean_relative_error(m, ref) < 1e-6


def test_roundtrip_ragusa16(ragusa16):
    m = coo_to_bmsparse(
        ragusa16.row.astype(np.int32),
        ragusa16.col.astype(np.int32),
        ragusa16.data.astype(np.float32),
        ragusa16.shape,
    )
    assert m.nnz == 81
    assert mean_relative_error(m, ragusa16) < 1e-6


def test_offsets_and_block_order():
    # blocks must be sorted by (brow, bcol); offsets = exclusive scan of popcount
    rows, cols, vals = random_coo(64, 64, density=0.1, seed=3)
    m = coo_to_bmsparse(rows, cols, vals, (64, 64))
    nb = int(m.nb)
    brow = np.asarray(m.brow)[:nb]
    bcol = np.asarray(m.bcol)[:nb]
    keys = brow.astype(np.int64) * 2**32 + bcol
    assert np.all(np.diff(keys) > 0)
    cnt = np.asarray(m.block_nnz())[:nb]
    off = np.asarray(m.offsets)[:nb]
    np.testing.assert_array_equal(off, np.cumsum(cnt) - cnt)
    assert cnt.sum() == m.nnz


def test_padding_blocks_are_identity():
    rows, cols, vals = random_coo(32, 32, density=0.2, seed=7)
    m = coo_to_bmsparse(rows, cols, vals, (32, 32))
    mp = m.pad_to(m.nb_pad + 17, m.nnz_pad + 5)
    d1 = np.asarray(m.decompress_blocks())
    d2 = np.asarray(mp.decompress_blocks())
    np.testing.assert_array_equal(d2[: m.nb_pad], d1)
    assert np.all(d2[m.nb_pad:] == 0)
    r1 = m.generate_coo()
    r2 = mp.generate_coo()
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a, b)


def test_decompress_blocks_dense_equiv():
    rows, cols, vals = random_coo(40, 40, density=0.15, seed=11)
    m = coo_to_bmsparse(rows, cols, vals, (40, 40))
    dense = np.zeros((40, 48))  # padded to whole blocks
    dense[rows, cols] = vals
    blocks = np.asarray(m.decompress_blocks())
    nb = int(m.nb)
    for k in range(nb):
        br, bc = int(m.brow[k]), int(m.bcol[k])
        expect = np.zeros((8, 8), np.float32)
        sub = dense[br * 8 : min((br + 1) * 8, 40), bc * 8 : (bc + 1) * 8]
        expect[: sub.shape[0], : sub.shape[1]] = sub
        np.testing.assert_allclose(blocks[k], expect, rtol=1e-6)


# ---------------------------------------------------------------------------
# CSR + binary IO
# ---------------------------------------------------------------------------
def test_csr_roundtrip():
    rows, cols, vals = random_coo(50, 70, density=0.08, seed=5)
    ref = sp.csr_matrix((vals, (rows, cols)), shape=(50, 70))
    csr = CSRMatrix.from_scipy(ref)
    m = csr_to_bmsparse(csr)
    assert mean_relative_error(m, ref) < 1e-6
    back = bmsparse_to_csr(m)
    assert (abs(back.to_scipy() - ref) > 1e-6).nnz == 0


def test_binary_io(tmp_path):
    rows, cols, vals = random_coo(48, 48, density=0.1, seed=9)
    m = coo_to_bmsparse(rows, cols, vals, (48, 48))
    p = str(tmp_path / "m.npz")
    save_bmsparse(p, m)
    m2 = load_bmsparse(p)
    assert m2.shape == m.shape and m2.nnz == m.nnz
    for a, b in zip(m.generate_coo(), m2.generate_coo()):
        np.testing.assert_array_equal(a, b)


def test_bf16_values():
    rows, cols, vals = random_coo(32, 32, density=0.2, seed=13)
    m = coo_to_bmsparse(rows, cols, vals.astype(jnp.bfloat16), (32, 32))
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(32, 32))
    # bf16 has ~3 decimal digits; tolerance accordingly
    assert mean_relative_error(m, ref) < 1e-2


def test_transpose():
    from bmsparse import transpose

    rows, cols, vals = random_coo(70, 120, density=0.06, seed=21)
    m = coo_to_bmsparse(rows, cols, vals, (70, 120))
    mt = transpose(m)
    assert mt.shape == (120, 70)
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(70, 120)).T.tocoo()
    r, c, v = mt.generate_coo()
    ref2 = sp.coo_matrix((ref.data, (ref.row, ref.col)), shape=(120, 70))
    got = sp.coo_matrix((v, (r, c)), shape=(120, 70))
    np.testing.assert_allclose(got.toarray(), ref2.toarray(), rtol=1e-6)
    # double transpose is the identity
    mtt = transpose(mt)
    r2, c2, v2 = mtt.generate_coo()
    ro, co, vo = m.generate_coo()
    np.testing.assert_array_equal(r2, ro)
    np.testing.assert_array_equal(c2, co)
    np.testing.assert_allclose(v2, vo)
    # transposed-storage result feeds SpGEMM's B operand
    from bmsparse.ops.spgemm import spgemm

    bt = transpose(m, transposed=True)
    assert bt.transposed
    c_mm = spgemm(m, bt)  # A @ A.T
    a_sp = sp.coo_matrix((vals, (rows, cols)), shape=(70, 120)).tocsr()
    assert c_mm.compare((a_sp @ a_sp.T).tocoo()) < 1e-5


def test_host_converter_matches_device():
    # the numpy host converter (reference reader.cu analogue) must produce
    # bit-identical structure to the jitted XLA pipeline
    for shape, transposed in [((96, 80), False), ((96, 80), True)]:
        rows, cols, vals = random_coo(*shape, density=0.12, seed=31)
        a = coo_to_bmsparse(rows, cols, vals, shape, transposed=transposed)
        b = coo_to_bmsparse(
            rows, cols, vals, shape, transposed=transposed, backend="host"
        )
        nb = int(a.nb)
        assert int(b.nb) == nb
        for f in ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f))[:nb],
                np.asarray(getattr(b, f))[:nb], err_msg=f,
            )
        np.testing.assert_allclose(
            np.asarray(a.values)[: a.nnz], np.asarray(b.values)[: b.nnz]
        )


def test_host_converter_duplicate_coordinates_summed():
    """Duplicate (row, col) triplets must be summed (scipy/cusp COO
    assembly semantics), not corrupt bitmap/value alignment."""
    from bmsparse import coo_to_bmsparse

    r = np.array([0, 0, 5, 5, 3], np.int32)
    c = np.array([1, 1, 3, 3, 2], np.int32)
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    m = coo_to_bmsparse(r, c, v, (8, 8), backend="host")
    dense = m.to_scipy().toarray()
    assert dense[0, 1] == 3.0 and dense[5, 3] == 7.0 and dense[3, 2] == 5.0
    assert m.nnz == 3


def test_host_converter_empty_matches_device_convention():
    """Empty input yields the one-padding-block container, like the
    device path's n == 0 special case."""
    from bmsparse import coo_to_bmsparse

    z = np.zeros((0,), np.int32)
    m = coo_to_bmsparse(z, z, np.zeros((0,), np.float32), (16, 16),
                        backend="host")
    assert int(m.nb) == 0
    assert m.brow.shape[0] == 1 and int(m.brow[0]) == m.block_rows
    assert int(m.bmp_hi[0]) == 0 and int(m.bmp_lo[0]) == 0
