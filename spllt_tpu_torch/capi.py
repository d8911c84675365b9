"""Python side of the C ABI (called from ``native/capi.cpp`` through the
embedded CPython).

The C interface of ``include/spllt_tpu.h``: opaque handles over the
analyse / factor / solve phases on raw CSC arrays (the reference's
akeep/fkeep handles, SpLLT:include/spllt_iface.h:14-47).  A C caller links
the library that :func:`.numeric._build.build_capi` builds from
``native/capi.cpp``, which embeds CPython and calls the functions below.
Raw pointers cross the boundary as integers and are wrapped here with ctypes
and NumPy without copying (the pattern and values are copied once into the
symbolic object, results are written back through the caller's buffer).

The header's options struct has no device field: the factor runs on the
device that the environment variable ``SPLLT_CAPI_DEVICE`` names, ``cuda``
when it is unset.  Without a card a factor returns -3 (the C wrapper's
error path, the message on stderr); it never runs on the CPU instead.

Return codes: 0 ok, -1 not positive definite, -2 solve before factor.
Handles are integers into a process-wide registry; the C side owns their
lifetime through ``spllt_tpu_free``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_registry: dict[int, dict] = {}
_next_id = [1]


def device() -> str:
    """The torch device of the C interface's factors."""
    return os.environ.get("SPLLT_CAPI_DEVICE", "cuda")


def _wrap(ptr: int, n: int, ctype):
    """NumPy view of a raw C pointer (no copy)."""
    if n == 0:
        return np.empty(0, dtype=np.ctypeslib.as_ctypes_type(ctype))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _put(obj) -> int:
    h = _next_id[0]
    _next_id[0] += 1
    _registry[h] = obj
    return h


def analyse_c(n: int, nptr: int, ptr_addr: int, row_addr: int,
              nb: int, nemin: int, ordering: str, schedule: str,
              precision: str, refine: int) -> tuple[int, int, float, int]:
    """Returns (handle, num_factor, num_flops, num_nodes)."""
    from . import Options, analyse
    from .sparse.csc import CscMatrix

    colptr = _wrap(ptr_addr, nptr, ctypes.c_int64).astype(np.int64)
    nnz = int(colptr[-1])
    rowind = _wrap(row_addr, nnz, ctypes.c_int64).astype(np.int64)
    a = CscMatrix(n, colptr, rowind, np.zeros(nnz))
    opts = Options(nb=nb, nemin=nemin, ordering=ordering,
                   schedule=schedule, precision=precision, refine=refine,
                   mode="batched", dtype="float32", device=device())
    symb = analyse(a, opts)
    h = _put({"symb": symb, "a_pattern": a, "num": None})
    inf = symb.inform
    return h, int(inf.num_factor), float(inf.num_flops), int(symb.nnodes)


def factor_c(h: int, val_addr: int) -> int:
    """Numeric factorization of the analysed pattern with new values.
    Returns 0 ok, -1 not positive definite."""
    from . import factor
    from .errors import NotPositiveDefiniteError
    from .sparse.csc import CscMatrix

    st = _registry[h]
    pat = st["a_pattern"]
    vals = _wrap(val_addr, pat.nnz, ctypes.c_double).copy()
    try:
        st["num"] = factor(st["symb"],
                           a=CscMatrix(pat.n, pat.colptr, pat.rowind, vals))
    except NotPositiveDefiniteError:
        return -1
    return 0


def solve_c(h: int, nrhs: int, x_addr: int, job: int) -> int:
    """In-place solve: x [n*nrhs, column-major] holds the rhs on entry and
    the solution on return.  job: 0 both, 1 forward, 2 backward."""
    from . import solve

    st = _registry[h]
    num = st["num"]
    if num is None:
        return -2
    n = st["symb"].n
    xbuf = _wrap(x_addr, n * nrhs, ctypes.c_double)
    b = xbuf.reshape(nrhs, n).T.copy()           # column-major view
    xbuf[:] = np.asarray(solve(num, b, job=job)).T.reshape(-1)
    return 0


def free_c(h: int) -> int:
    _registry.pop(h, None)
    return 0
