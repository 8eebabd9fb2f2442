"""MatrixMarket ingestion — the reference's file-loading path
(`bmSpMatrix(path, transposed)` parse loop, ref: src/bmSpMatrix.cu:112-161,
and CUSP's `cusp::io::read_matrix_market_file`).

Parsing strategy, fastest available first:
  1. scipy.io.mmread — scipy >= 1.12 vendors fast_matrix_market, a
     multithreaded C++ parser (measured 2x our single-threaded extension),
  2. native C extension `_mmparse` (native/mmparse.cpp; the analogue of
     the reference's C++ host parser / legacy `mmread_bmSparse`,
     ref: src/reader.cu:49-110) — the zero-dependency fallback, selected
     with native=True or when scipy is unavailable,
with identical semantics: 1-based -> 0-based indices, `symmetric` header
expands off-diagonal entries to both triangles (ref:
src/bmSpMatrix.cu:133-149).
"""

from __future__ import annotations

import os

import numpy as np

try:  # native fast path (built via `make native` / pip install -e .)
    from . import _mmparse  # type: ignore[attr-defined]

    HAVE_NATIVE = True
except ImportError:
    _mmparse = None
    HAVE_NATIVE = False


def read_matrix_market(
    path: str, dtype=np.float32, native: bool | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple[int, int]]:
    """Read a MatrixMarket coordinate file into COO triplets.

    Returns (rows, cols, values, (num_rows, num_cols)) with int32 indices.
    Symmetric/skew-symmetric/hermitian files are expanded to general form,
    matching the reference's symmetric expansion (added entries appended
    after the originals; order is irrelevant — conversion sorts).
    """
    if not os.path.exists(path) and os.path.exists(path + ".mtx"):
        # The reference CLI appends ".mtx" to names (src/bmSparse_SPGEMM.cu:1261).
        path = path + ".mtx"
    if native is None:
        try:
            import scipy.io  # noqa: F401

            use_native = False
        except ImportError:  # pragma: no cover
            use_native = HAVE_NATIVE
    else:
        use_native = native
    if use_native and _mmparse is not None:
        rows, cols, vals, nr, nc, sym = _mmparse.parse(path)
        rows = rows.astype(np.int32, copy=False)
        cols = cols.astype(np.int32, copy=False)
        vals = vals.astype(dtype, copy=False)
        if sym:
            off = rows != cols
            r0, c0, v0 = rows, cols, vals
            mirrored = -v0[off] if sym == 2 else v0[off]  # 2 = skew
            rows = np.concatenate([r0, c0[off]])
            cols = np.concatenate([c0, r0[off]])
            vals = np.concatenate([v0, mirrored])
        return rows, cols, vals, (nr, nc)

    import scipy.io

    m = scipy.io.mmread(path)  # already symmetric-expanded, 0-based
    m = m.tocoo()
    return (
        m.row.astype(np.int32),
        m.col.astype(np.int32),
        np.asarray(m.data, dtype=dtype),
        (m.shape[0], m.shape[1]),
    )


def write_matrix_market(path: str, rows, cols, vals, shape) -> None:
    import scipy.io
    import scipy.sparse as sp

    scipy.io.mmwrite(path, sp.coo_matrix((vals, (rows, cols)), shape=shape))


def mmread_bmsparse(
    path: str,
    transposed: bool = False,
    dtype=np.float32,
    **convert_kw,
):
    """File -> BmSparse in one call (the reference ctor's full pipeline).

    File data is host data, so conversion defaults to the vectorized-numpy
    host backend (the reference's host converter analogue) — the device
    pipeline would pay a fresh XLA compile per nnz-shape. Pass
    backend="device" for the XLA pipeline.
    """
    from ..format.convert import coo_to_bmsparse

    convert_kw.setdefault("backend", "host")
    if convert_kw["backend"] == "host":
        convert_kw.pop("compact", None)
    rows, cols, vals, shape = read_matrix_market(path, dtype=dtype)
    return coo_to_bmsparse(
        rows, cols, vals, shape, transposed=transposed, **convert_kw
    )
