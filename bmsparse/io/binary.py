"""Binary persistence of BmSparse matrices.

The reference includes cusp/io/binary.h under the comment "Dumping bmSparse
matrices to disk" (ref: src/bmSparse_SPGEMM.cu:21-27) but the dump code did
not survive; CUSP provides matrix persistence (cusp/cusp/io/binary.h). This
module supplies that capability natively: a versioned .npz dump of the five
format arrays plus metadata, so converted matrices can be cached between
benchmark runs.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..format.bmsparse import BmSparse

_FORMAT_VERSION = 1


def save_bmsparse(path: str, m: BmSparse) -> None:
    # arrays via the host cache (the converter/loader registered host
    # copies), uncompressed npz (random float payloads barely compress)
    from ..format.hostcache import fetch_format_arrays

    brow, bcol, hi, lo, offsets, values = fetch_format_arrays(m)
    np.savez(
        path,
        version=np.int32(_FORMAT_VERSION),
        brow=brow, bcol=bcol, bmp_hi=hi, bmp_lo=lo,
        offsets=offsets, values=values,
        meta=np.array(
            [m.num_rows, m.num_cols, m.nnz, int(m.transposed)], np.int64
        ),
    )


def load_bmsparse(path: str) -> BmSparse:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unsupported bmsparse dump version {z['version']}")
        nr, nc, nnz, transposed = (int(x) for x in z["meta"])
        nb = len(z["brow"])
        arrays = dict(
            brow=np.asarray(z["brow"], np.int32),
            bcol=np.asarray(z["bcol"], np.int32),
            bmp_hi=np.asarray(z["bmp_hi"], np.uint32),
            bmp_lo=np.asarray(z["bmp_lo"], np.uint32),
            offsets=np.asarray(z["offsets"], np.int32),
            values=np.asarray(z["values"]),
        )
    m = BmSparse(
        brow=jnp.asarray(arrays["brow"]),
        bcol=jnp.asarray(arrays["bcol"]),
        bmp_hi=jnp.asarray(arrays["bmp_hi"]),
        bmp_lo=jnp.asarray(arrays["bmp_lo"]),
        offsets=jnp.asarray(arrays["offsets"]),
        values=jnp.asarray(arrays["values"]),
        nb=jnp.int32(nb),
        num_rows=nr,
        num_cols=nc,
        nnz=nnz,
        transposed=bool(transposed),
    )
    from ..format import hostcache

    hostcache.put(m, **arrays)
    return m


# ---------------------------------------------------------------------------
# Prepared-plan persistence: the tiered SpMV plan is a pure function of
# the matrix, deterministic, and costs seconds of host numpy to build at
# SuiteSparse scale — so benchmark/CLI loops cache it on disk next to the
# matrix dump. The pickle holds the
# plan's pytree with numpy leaves; loading re-attaches the live container
# and uploads the leaves in one pass.
# ---------------------------------------------------------------------------
_PLAN_DUMP_VERSION = 1


def save_prepared(path: str, p) -> None:
    """Dump a Prepared plan (ops/plan.py) to `path` (pickle).

    Device leaves are pulled to host once (the dump is a one-time cost
    per matrix/dtype); the container itself is NOT stored — pair the
    dump with save_bmsparse and re-attach on load."""
    import dataclasses as _dc
    import pickle

    import jax

    from ..ops.plan import PLAN_LAYOUT_VERSION, Prepared

    assert isinstance(p, Prepared)
    stripped = _dc.replace(p, m=None, dense_flat_=None)
    leaves, treedef = jax.tree_util.tree_flatten(stripped)
    leaves = [np.asarray(x) for x in leaves]
    with open(path, "wb") as f:
        pickle.dump(
            {
                "version": _PLAN_DUMP_VERSION,
                "layout_version": PLAN_LAYOUT_VERSION,
                "treedef": treedef,
                "leaves": leaves,
            },
            f,
            protocol=pickle.HIGHEST_PROTOCOL,
        )


def load_prepared(path: str, m: BmSparse):
    """Load a Prepared plan dumped by save_prepared and attach it to the
    live container `m` (which must be the same matrix). Returns None when
    the dump's version/layout stamps don't match the running code —
    callers fall back to prepare(m)."""
    import dataclasses as _dc
    import pickle

    import jax

    from ..ops.plan import PLAN_LAYOUT_VERSION

    with open(path, "rb") as f:
        d = pickle.load(f)
    if (d.get("version") != _PLAN_DUMP_VERSION
            or d.get("layout_version") != PLAN_LAYOUT_VERSION):
        return None
    leaves = [
        jnp.asarray(x) if isinstance(x, np.ndarray) else x
        for x in d["leaves"]
    ]
    p = jax.tree_util.tree_unflatten(d["treedef"], leaves)
    return _dc.replace(p, m=m)
