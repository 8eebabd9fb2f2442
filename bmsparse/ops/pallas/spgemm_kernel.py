"""Fused task-SELL SpGEMM numeric kernel for the GPU (Pallas, Triton route).

The analogue of the reference's fused numeric kernels multiplyV11-V15
(ref: src/bmSparse_SPGEMM.cu:205-733): each program owns BLOCK_C output
blocks of one sigma chunk, walks their K task slots in a loop, gathers the
two 8x8 operand tiles of every task straight from device memory (64
contiguous values per tile), does the 512 multiply-adds and the K-sum in
registers, and writes each C block once. The XLA formulation of the same
math (ops/spgemm.py:_numeric_sell_slab) first materialises the gathered
operand tensors in device memory and reads them back.

Layouts:
  * operand tables are row-major (nb + 1, 8, 8): one tile per row, the
    last row all zeros (the sentinel that padding slots point at);
  * slot tables are the planner's (chunks, K, 128) int32 arrays: slot
    (c, k, lane) names the k-th task of C block c * 128 + lane;
  * the result is (chunks * 128, 64) f32, row-major tiles in sigma order
    (the layout the compress stage consumes).

The per-task product is 8x8 and far below a tensor-core tile, so it runs
as broadcast multiply-adds on the CUDA cores; no dot, so no TF32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_C = 16        # output blocks per program; a power of two dividing 128
NUM_WARPS = 4
NUM_STAGES = 2


def _kernel(ta_ref, tb_ref, a_ref, b_ref, o_ref, *, k: int, block_c: int):
    p = pl.program_id(0)
    per_chunk = 128 // block_c
    c = p // per_chunk
    lane0 = (p % per_chunk) * block_c

    def body(kk, acc):
        ia = ta_ref[c, kk, pl.ds(lane0, block_c)]
        ib = tb_ref[c, kk, pl.ds(lane0, block_c)]
        a = a_ref[ia, :, :].astype(jnp.float32)         # (block_c, 8, 8)
        b = b_ref[ib, :, :].astype(jnp.float32)
        return acc + jnp.sum(a[:, :, :, None] * b[:, None, :, :], axis=2)

    o_ref[...] = jax.lax.fori_loop(
        0, k, body, jnp.zeros((block_c, 8, 8), jnp.float32))


@functools.partial(
    jax.jit,
    static_argnames=("block_c", "num_warps", "num_stages", "interpret"))
def numeric_sell_triton(
    a_ext: jax.Array, b_ext: jax.Array, ta: jax.Array, tb: jax.Array,
    *, block_c: int = BLOCK_C, num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES, interpret: bool = False,
) -> jax.Array:
    """Products + K-sum of one K-group.

    a_ext/b_ext: (nb + 1, 64) row-major dense tiles, zero sentinel row last
    (any float dtype; bf16 tiles are widened to f32 in registers).
    ta/tb: (chunks, K, 128) int32 slot operand indices.
    Returns (chunks * 128, 64) f32 C tiles, matching
    ops/spgemm.py:_numeric_sell_group.

    interpret=True runs the kernel in the Pallas interpreter (CPU tests);
    otherwise it compiles for the GPU and refuses any other backend.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Triton SpGEMM kernel (impl='pallas') needs a GPU backend; "
            f"this process runs on {jax.default_backend()!r}")
    if 128 % block_c:
        raise ValueError(f"block_c={block_c} must divide 128")
    ch, k, _ = ta.shape
    out = pl.pallas_call(
        functools.partial(_kernel, k=k, block_c=block_c),
        grid=(ch * (128 // block_c),),
        out_specs=pl.BlockSpec((block_c, 8, 8), lambda p: (p, 0, 0)),
        # vma: varies like the slot tables (per shard under shard_map)
        out_shape=jax.ShapeDtypeStruct((ch * 128, 8, 8), jnp.float32,
                                       vma=jax.typeof(ta).vma),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages),
        interpret=interpret,
        name="spgemm_sell_triton",
    )(ta, tb, a_ext.reshape(-1, 8, 8), b_ext.reshape(-1, 8, 8))
    return out.reshape(ch * 128, 64)
