"""bmsparse — a bitmap-sparse (bmSparse) linear algebra framework: the
capabilities of GonzaBerger/bmSparse-SPGEMM-SPMV re-designed for
JAX/XLA/Pallas, run on NVIDIA GPUs.

Public API:
    BmSparse, CSRMatrix            — containers
    coo_to_bmsparse, csr_to_bmsparse, bmsparse_to_coo, bmsparse_to_csr
    read_matrix_market, mmread_bmsparse, save_bmsparse, load_bmsparse
    spmv, csr_spmv                 — u = A @ v
    spgemm                         — C = A @ B
    prepare (ops.plan)             — tiered per-matrix SpMV/operand plan
    prepare_product (ops.product)  — structure-cached iterated SpGEMM
    mean_relative_error            — reference `compare()` semantics
"""

from .config import BLOCK_HEIGHT, BLOCK_SIZE, BLOCK_WIDTH, get_config, set_config
from .format.bmsparse import BmSparse
from .format.convert import (
    CSRMatrix,
    bmsparse_to_coo,
    bmsparse_to_csr,
    coo_to_bmsparse,
    csr_to_bmsparse,
    transpose,
)
from .io.binary import load_bmsparse, save_bmsparse
from .io.matrix_market import mmread_bmsparse, read_matrix_market
from .oracle.compare import assert_allclose_sparse, mean_relative_error
from .ops.spmv import csr_spmv, spmv

__version__ = "0.1.0"


def spgemm(*args, **kwargs):
    from .ops.spgemm import spgemm as _spgemm

    return _spgemm(*args, **kwargs)


def prepare_product(*args, **kwargs):
    from .ops.product import prepare_product as _pp

    return _pp(*args, **kwargs)


def prepare(*args, **kwargs):
    from .ops.plan import prepare as _prepare

    return _prepare(*args, **kwargs)
