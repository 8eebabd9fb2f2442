"""Cached SpGEMM products: pay the symbolic + planning cost once per
structure, re-run only the numeric phase per multiply.

The reference re-runs its full pipeline every call (it has no caching
layer). The planner's sorts, scans and host syncs cost time on every
call; iterated products with fixed structure — A^k chains,
polynomial/Chebyshev filters, graph multi-hop expansions, re-multiplies
after value updates — should not pay them repeatedly.
`prepare_product(A, B)` runs T1-T6 + the device numeric plan
(ops/spgemm.py:_plan_product) and caches every structure-dependent
artifact: the per-K-group slot operand indices, the compress tables, and
the C container metadata. Calling the product then costs only:

  gather operand tiles -> fused block products -> K-sum -> bit-pack

which is the device-speed numeric path with zero host work and zero
host syncs.

Values may change between calls as long as the STRUCTURE (bitmaps/keys)
is unchanged: pass the updated operands to __call__.
"""

from __future__ import annotations

from ..format.bmsparse import BmSparse
from ..utils.timing import PhaseTimer
from . import spgemm as sg


def _structure_fingerprint(m: BmSparse):
    """Cheap bitmap hash for host-reachable containers, None otherwise.

    Count checks (nb/nnz/shape) collide easily for same-density rebuilds;
    the fingerprint catches a changed structure when comparing is free
    (numpy-backed or CPU-resident arrays). Device-resident operands stay
    unchecked — fetching bitmaps per call would cost a D->H sync, which
    is exactly what the cached product exists to avoid."""
    import numpy as np

    def host_ok(x):
        if isinstance(x, np.ndarray):
            return True
        try:
            return all(d.platform == "cpu" for d in x.devices())
        except Exception:
            return False

    if not (host_ok(m.bmp_hi) and host_ok(m.bmp_lo)):
        return None
    hi = np.asarray(m.bmp_hi).tobytes()
    lo = np.asarray(m.bmp_lo).tobytes()
    return hash((hi, lo))


class PreparedProduct:
    """A structure-frozen C = A @ B with a device-only numeric path."""

    def __init__(self, plan: "sg._ProductPlan", impl: str):
        self.plan = plan
        self.impl = impl
        self.shape = (plan.a.num_rows, plan.b.num_cols)
        self.num_c_blocks = plan.num_c_blocks
        self.num_c_nnz = plan.num_c_nnz
        self._fp_a = _structure_fingerprint(plan.a)
        self._fp_b = _structure_fingerprint(plan.b)

    def __call__(self, a=None, b=None) -> BmSparse:
        """Multiply with the cached structure — one jitted dispatch
        (ops/spgemm.py::_numeric_stage), zero host syncs.

        a/b: optional operands with updated VALUES but identical structure
        (same blocks/bitmaps); BmSparse or Prepared. Defaults to the
        operands captured at prepare time. Block count, nnz, and shape
        are always verified; when both the prepare-time and the updated
        operand are host-reachable, a bitmap fingerprint is compared
        too (counts collide easily for same-density rebuilds). A
        device-resident operand with matching counts but different
        bitmaps stays the caller's contract violation — checking it
        would cost the D->H sync this cache exists to avoid.
        """
        from .plan import Prepared

        p = self.plan
        a_flat = p.a_flat
        b_flat = p.b_flat
        if a is not None:
            am = a.m if isinstance(a, Prepared) else a
            if (int(am.nb) != int(p.a.nb) or am.nnz != p.a.nnz
                    or am.shape != p.a.shape):
                raise ValueError("operand A structure changed; re-prepare")
            if self._fp_a is not None:
                fp = _structure_fingerprint(am)
                if fp is not None and fp != self._fp_a:
                    raise ValueError(
                        "operand A bitmaps changed; re-prepare")
            a_flat = (a.dense_flat if isinstance(a, Prepared)
                      else a.decompress_blocks_flat())
            if a_flat.shape != p.a_flat.shape:
                raise ValueError("operand A structure changed; re-prepare")
        if b is not None:
            bm_ = b.m if isinstance(b, Prepared) else b
            if (int(bm_.nb) != int(p.b.nb) or bm_.nnz != p.b.nnz
                    or bm_.shape != p.b.shape):
                raise ValueError("operand B structure changed; re-prepare")
            if self._fp_b is not None:
                fp = _structure_fingerprint(bm_)
                if fp is not None and fp != self._fp_b:
                    raise ValueError(
                        "operand B bitmaps changed; re-prepare")
            b_flat = (b.dense_flat if isinstance(b, Prepared)
                      else b.decompress_blocks_flat())
            if b_flat.shape != p.b_flat.shape:
                raise ValueError("operand B structure changed; re-prepare")

        c_values = sg._numeric_from_plan(p, self.impl, a_flat, b_flat)
        return sg._assemble_c(p, c_values)


def prepare_product(a, b, impl: str | None = None) -> PreparedProduct:
    """Build the cached product plan for C = A @ B (see module docstring).

    Operands may be BmSparse or Prepared; impl as in ops.spgemm.spgemm
    ("auto" | "sell" | "pallas"; the "xla" variant has no slot layout to
    cache).
    """
    from .plan import Prepared, as_matrix

    a_prep = a if isinstance(a, Prepared) else None
    b_prep = b if isinstance(b, Prepared) else None
    am, bm = as_matrix(a), as_matrix(b)
    sg._check_operands(am, bm)
    impl = sg.resolve_impl(impl)
    if impl not in ("sell", "pallas"):
        raise ValueError(
            f"prepare_product supports impl 'sell'|'pallas', got {impl!r}"
        )
    timer = PhaseTimer(enabled=False)
    plan = sg._plan_product(am, bm, a_prep, b_prep, timer, False)
    return PreparedProduct(plan, impl)
