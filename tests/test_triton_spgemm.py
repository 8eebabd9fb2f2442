"""Fused Triton SpGEMM numeric kernel (ops/pallas/spgemm_kernel.py):
interpret-mode correctness against a numpy block-product reference and
the XLA task-SELL form, the refusal to run interpreted by default, and
(on the card, `gpu` marker) the compiled kernel.

Reference parity: the kernel plays the role of the reference's fused
numeric kernels multiplyV11-V15 (ref: src/bmSparse_SPGEMM.cu:205-733)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bmsparse import coo_to_bmsparse
from bmsparse.ops import spgemm as sg
from bmsparse.ops.pallas import spgemm_kernel as sk

from conftest import random_coo


def _tables(nb, ch, k, seed, dtype):
    """Operand tables with a zero sentinel row and slot tables that hit
    the sentinel in some slots (padding)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((nb + 1, 64)).astype(np.float32)
    b = rng.standard_normal((nb + 1, 64)).astype(np.float32)
    a[nb] = 0.0
    b[nb] = 0.0
    a = np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))
    b = np.asarray(jnp.asarray(b, dtype).astype(jnp.float32))
    ta = rng.integers(0, nb + 1, (ch, k, 128)).astype(np.int32)
    tb = rng.integers(0, nb + 1, (ch, k, 128)).astype(np.int32)
    ta[:, -1, ::3] = nb
    return a, b, ta, tb


def _reference(a, b, ta, tb):
    ch, k, _ = ta.shape
    out = np.zeros((ch, 128, 8, 8))
    for kk in range(k):
        out += (a[ta[:, kk]].reshape(ch, 128, 8, 8).astype(np.float64)
                @ b[tb[:, kk]].reshape(ch, 128, 8, 8))
    return out.reshape(ch * 128, 64)


# chunk counts 1 and 3 are not multiples of any power-of-two block; k=1
# is the single-task group
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("ch,k", [(3, 1), (1, 3), (3, 2)])
def test_kernel_interpret_matches_reference(dtype, ch, k):
    a, b, ta, tb = _tables(300, ch, k, seed=ch * 10 + k, dtype=dtype)
    out = sk.numeric_sell_triton(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype), jnp.asarray(ta),
        jnp.asarray(tb), interpret=True)
    assert out.shape == (ch * 128, 64) and out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out), _reference(a, b, ta, tb),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_c", [16, 64, 128])
def test_kernel_block_sizes_agree(block_c):
    a, b, ta, tb = _tables(100, 2, 2, seed=5, dtype=jnp.float32)
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(ta), jnp.asarray(tb))
    got = sk.numeric_sell_triton(*args, block_c=block_c, interpret=True)
    np.testing.assert_allclose(np.asarray(got), _reference(a, b, ta, tb),
                               rtol=1e-5, atol=1e-5)


def test_kernel_rejects_block_not_dividing_128():
    a, b, ta, tb = _tables(10, 1, 1, seed=0, dtype=jnp.float32)
    with pytest.raises(ValueError, match="divide 128"):
        sk.numeric_sell_triton(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(ta), jnp.asarray(tb),
                               block_c=48, interpret=True)


def test_kernel_refuses_non_gpu_backend():
    """Without interpret=True the kernel never falls back to the
    interpreter: on the CPU it raises."""
    a, b, ta, tb = _tables(10, 1, 1, seed=0, dtype=jnp.float32)
    with pytest.raises(ValueError, match="needs a GPU"):
        sk.numeric_sell_triton(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(ta), jnp.asarray(tb))


def test_spgemm_pallas_raises_on_cpu():
    rows, cols, vals = random_coo(64, 64, density=0.1, seed=3)
    a = coo_to_bmsparse(rows, cols, vals, (64, 64))
    bt = coo_to_bmsparse(rows, cols, vals, (64, 64), transposed=True)
    with pytest.raises(ValueError, match="needs a GPU"):
        sg.spgemm(a, bt, impl="pallas")


def test_resolve_impl():
    backend = jax.default_backend()
    assert sg.resolve_impl("auto") == (
        "pallas" if backend == "gpu" else "sell")
    assert sg.resolve_impl("xla") == "xla"
    with pytest.raises(ValueError):
        sg.resolve_impl("mxu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_spgemm_pallas_interpret_matches_sell(monkeypatch, dtype):
    """The whole spgemm pipeline with the kernel interpreted agrees with
    impl="sell" on the same plan (bf16 tiles widened in-kernel)."""
    monkeypatch.setattr(sk, "numeric_sell_triton", functools.partial(
        sk.numeric_sell_triton, interpret=True))
    rows, cols, vals = random_coo(200, 200, density=0.04, seed=9)
    a = coo_to_bmsparse(rows, cols, vals, (200, 200)).astype(dtype)
    bt = coo_to_bmsparse(rows, cols, vals, (200, 200),
                         transposed=True).astype(dtype)
    c_p = sg.spgemm(a, bt, impl="pallas")
    c_s = sg.spgemm(a, bt, impl="sell")
    assert c_p.nnz == c_s.nnz
    np.testing.assert_allclose(np.asarray(c_p.values)[: c_p.nnz],
                               np.asarray(c_s.values)[: c_s.nnz],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu):
    """The compiled kernel (no interpreter) against the numpy reference,
    in float32 and with bf16 tiles, including a K=1 group."""
    for dtype, (ch, k) in ((jnp.float32, (3, 2)), (jnp.bfloat16, (5, 1))):
        a, b, ta, tb = _tables(1000, ch, k, seed=7, dtype=dtype)
        out = sk.numeric_sell_triton(
            jnp.asarray(a, dtype), jnp.asarray(b, dtype),
            jnp.asarray(ta), jnp.asarray(tb))
        np.testing.assert_allclose(np.asarray(out),
                                   _reference(a, b, ta, tb),
                                   rtol=1e-5, atol=1e-5)
