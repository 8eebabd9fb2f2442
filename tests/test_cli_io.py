"""CLI drivers + MatrixMarket ingestion (native and scipy paths).

Covers the reference's driver surface (SpGEMM main,
ref: src/bmSparse_SPGEMM.cu:1226-1288; SpMV main,
ref: src/bmSparse_SPMV.cu:232-312; batch harnesses spgemm_run_batch.sh /
spmv_run_batch.sh) and the host parser (ref: src/bmSpMatrix.cu:112-161).
"""

import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from bmsparse.io.matrix_market import HAVE_NATIVE, read_matrix_market

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "real")


# ---------------------------------------------------------------------------
# native parser
# ---------------------------------------------------------------------------
@pytest.mark.skipif(not HAVE_NATIVE, reason="native _mmparse not built")
def test_native_parser_matches_scipy():
    path = os.path.join(DATA, "A_matrix.mtx")
    r1, c1, v1, s1 = read_matrix_market(path, native=True)
    r2, c2, v2, s2 = read_matrix_market(path, native=False)
    assert s1 == s2
    k1, k2 = np.lexsort((c1, r1)), np.lexsort((c2, r2))
    np.testing.assert_array_equal(r1[k1], r2[k2])
    np.testing.assert_array_equal(c1[k1], c2[k2])
    np.testing.assert_allclose(v1[k1], v2[k2])


@pytest.mark.skipif(not HAVE_NATIVE, reason="native _mmparse not built")
def test_native_parser_symmetric_pattern_skew(tmp_path):
    m = sp.random(40, 40, 0.08, random_state=0)
    m = (m + m.T).tocoo()
    p = tmp_path / "sym.mtx"
    scipy.io.mmwrite(str(p), m, symmetry="symmetric")
    r, c, v, s = read_matrix_market(str(p), native=True)
    np.testing.assert_allclose(
        sp.coo_matrix((v, (r, c)), shape=s).toarray(), m.toarray()
    )

    p = tmp_path / "pat.mtx"
    p.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                 "3 3 2\n1 2\n3 3\n")
    r, c, v, s = read_matrix_market(str(p), native=True)
    assert list(v) == [1.0, 1.0] and s == (3, 3)
    assert list(r) == [0, 2] and list(c) == [1, 2]

    p = tmp_path / "skew.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                 "3 3 2\n2 1 5.0\n3 2 -1.5\n")
    r, c, v, s = read_matrix_market(str(p), native=True)
    a = sp.coo_matrix((v, (r, c)), shape=s).toarray()
    np.testing.assert_allclose(a, -a.T)


@pytest.mark.skipif(not HAVE_NATIVE, reason="native _mmparse not built")
def test_native_parser_rejects_garbage(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("not a matrix market file\n")
    with pytest.raises(ValueError):
        read_matrix_market(str(p), native=True)
    with pytest.raises(FileNotFoundError):
        read_matrix_market(str(tmp_path / "missing_file"), native=True)


def test_mtx_suffix_appended():
    # reference CLI passes names without .mtx (src/bmSparse_SPGEMM.cu:1261)
    r, c, v, s = read_matrix_market(os.path.join(DATA, "A_matrix"))
    assert s == (24, 24) and len(r) == 81


# ---------------------------------------------------------------------------
# CLI drivers
# ---------------------------------------------------------------------------
def test_cli_spmv(capsys):
    from bmsparse.cli.spmv import main

    rc = main([DATA, "A_matrix", "--check", "--iters", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Parsing data:" in out
    assert "bmSparse SpMV execution:" in out
    assert "Final:" in out


def test_cli_spgemm(capsys):
    from bmsparse.cli.spgemm import main

    rc = main([DATA, "A_matrix", "B_matrix", "0", "5", "0", "--check"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "bmSparse execution:" in out
    assert "C blocks: 9" in out
    assert "C nnz: 255" in out
    assert "Final:" in out


def test_cli_batch(tmp_path, capsys):
    from bmsparse.cli.batch import main

    lst = tmp_path / "list.txt"
    lst.write_text("A_matrix\nB_matrix\n")
    out_file = tmp_path / "out.txt"
    rc = main(["spmv", DATA, str(lst), str(out_file)])
    assert rc == 0
    text = out_file.read_text()
    assert "==== A_matrix ====" in text and "==== B_matrix ====" in text
    assert text.count("bmSparse SpMV execution:") == 2


def test_cli_batch_survives_bad_matrix(tmp_path):
    from bmsparse.cli.batch import main

    lst = tmp_path / "list.txt"
    lst.write_text("A_matrix\nno_such_matrix\n")
    out_file = tmp_path / "out.txt"
    rc = main(["spmv", DATA, str(lst), str(out_file)])
    assert rc == 1  # failure reported...
    text = out_file.read_text()
    assert "ERROR" in text  # ...but the sweep completed
    assert "==== A_matrix ====" in text


def test_cg_example():
    """The CG example converges on a small SPD system."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    import jax.numpy as jnp

    from cg import build_spd_stencil, cg
    from bmsparse import coo_to_bmsparse
    from bmsparse.ops.plan import prepare

    n = 512
    rows, cols, vals = build_spd_stencil(n)
    a = coo_to_bmsparse(rows, cols, vals, (n, n), backend="host")
    p = prepare(a)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n).astype(np.float32)
    x, hist = cg(p, jnp.asarray(b), 200)
    # residual should have dropped by many orders of magnitude
    assert float(hist[-1]) ** 0.5 < 1e-3 * float(hist[0]) ** 0.5
    # and A @ x == b
    ax = np.asarray(sp.coo_matrix((vals, (rows, cols)), shape=(n, n)) @ np.asarray(x))
    np.testing.assert_allclose(ax, b, rtol=1e-3, atol=1e-3)
