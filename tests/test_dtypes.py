"""Value-dtype coverage — the reference instantiates bmSpMatrix for
float, half and double (ref: src/bmSpMatrix.cu:435-437). Here: float32,
bfloat16 (the 16-bit type standing in for half — documented
substitution) and float64 (with x64 enabled).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from bmsparse import coo_to_bmsparse
from bmsparse.ops.plan import prepare
from bmsparse.ops.spmv import spmv
from bmsparse.ops.spgemm import spgemm

from conftest import random_coo


def _mk(dtype, shape=(96, 80), density=0.08, seed=11, transposed=False):
    rows, cols, vals = random_coo(*shape, density=density, seed=seed)
    m = coo_to_bmsparse(
        rows, cols, vals.astype(dtype), shape, transposed=transposed
    )
    ref = sp.coo_matrix(
        (np.asarray(vals, np.float64), (rows, cols)), shape=shape
    ).tocsr()
    return m, ref


@pytest.mark.parametrize(
    "dtype,rtol",
    [(jnp.float32, 1e-5), (jnp.bfloat16, 5e-2), (jnp.float64, 1e-5)],
)
def test_spmv_dtypes(dtype, rtol):
    if dtype == jnp.float64 and not jax.config.read("jax_enable_x64"):
        # without x64 JAX degrades f64 to f32 globally; the f64 path is
        # exercised in test_f64_subprocess below
        pytest.skip("x64 disabled")
    m, ref = _mk(dtype)
    assert m.values.dtype == dtype
    v = np.random.default_rng(5).standard_normal(m.num_cols)
    u = np.asarray(spmv(prepare(m), jnp.asarray(v, dtype)), np.float64)
    expect = ref @ v
    np.testing.assert_allclose(
        u, expect, rtol=rtol, atol=rtol * np.abs(expect).max()
    )


def test_prepare_f64_keeps_double():
    # without x64, f64 requests degrade; only check when enabled
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("x64 disabled")
    m, _ = _mk(jnp.float64)
    p = prepare(m)
    assert p.dense_flat.dtype == jnp.float64


def test_f64_subprocess():
    """Full double-precision SpMV in an x64-enabled interpreter (the
    reference's double instantiation, CPU path)."""
    import subprocess
    import sys

    code = (
        "import jax; jax.config.update('jax_enable_x64', True);"
        "jax.config.update('jax_platforms', 'cpu');"
        "import numpy as np, jax.numpy as jnp;"
        "from bmsparse import coo_to_bmsparse;"
        "from bmsparse.ops.plan import prepare;"
        "from bmsparse.ops.spmv import spmv;"
        "rng = np.random.default_rng(0);"
        "rows = rng.integers(0, 64, 200).astype(np.int32);"
        "cols = rng.integers(0, 64, 200).astype(np.int32);"
        "k = np.unique(rows.astype(np.int64)*64+cols);"
        "rows, cols = np.divmod(k, 64);"
        "vals = rng.standard_normal(len(rows));"
        "m = coo_to_bmsparse(rows.astype(np.int32), cols.astype(np.int32),"
        " vals, (64, 64));"
        "assert m.values.dtype == jnp.float64, m.values.dtype;"
        "p = prepare(m);"
        "assert p.dense_flat.dtype == jnp.float64;"
        "v = rng.standard_normal(64);"
        "u = np.asarray(spmv(p, jnp.asarray(v)));"
        "assert u.dtype == np.float64;"
        "import scipy.sparse as sp;"
        "ref = sp.coo_matrix((vals, (rows, cols)), shape=(64, 64)) @ v;"
        "assert np.abs(u - ref).max() < 1e-12, np.abs(u - ref).max();"
        # SpGEMM must PRESERVE f64 end-to-end (the numeric/compress
        # stages accumulate in promote_types(operand, f32), so f64
        # operands stay f64 — they used to silently downcast to f32)
        "from bmsparse.ops.spgemm import spgemm;"
        "sco = m.to_scipy().tocoo();"
        "bt = coo_to_bmsparse(sco.row.astype(np.int32),"
        " sco.col.astype(np.int32), sco.data, (64, 64), transposed=True);"
        "refc = m.to_scipy() @ m.to_scipy();"
        # BOTH numeric variants must preserve f64 (impl='xla' used to
        # compute products at f32 via block_matmul_flat's default
        # acc_dtype while returning a float64-labeled result)
        "\nfor impl in ('sell', 'xla'):\n"
        "    c = spgemm(m, bt, impl=impl)\n"
        "    assert c.values.dtype == jnp.float64, (impl, c.values.dtype)\n"
        "    rr, cc, vv = (np.asarray(t) for t in c.generate_coo())\n"
        "    got = sp.coo_matrix((vv, (rr, cc)), shape=(64, 64))\n"
        "    assert abs(got - refc).max() < 1e-12, (impl, abs(got - refc).max())\n"
        "print('f64 OK')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "f64 OK" in out.stdout


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 5e-2)])
def test_spgemm_dtypes(dtype, tol):
    # reference regime: low-precision inputs, f32 accumulate/output
    a, ra = _mk(dtype, shape=(64, 96), seed=3)
    b, rb = _mk(dtype, shape=(96, 72), seed=4, transposed=True)
    c = spgemm(a, b)
    assert c.values.dtype == jnp.float32
    err = c.compare((ra @ rb).tocoo())
    assert err < tol
