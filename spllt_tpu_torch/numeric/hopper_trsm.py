"""Batched right triangular solve (trsm): ``dst ← dst · L^-T``.

``trsm(diag, dst, kvec)``: for every pair, L is the leading kvec×kvec lower
triangle of the diag tile written by potrf; output columns >= kvec are
zero.  Rows >= kvec of the diag tile hold ``B·L^-T`` values of the bordered
potrf; they are junk for this purpose and never act as pivots.

Kernel note.  Replaces the TPU kernel ``spllt_tpu/numeric/pallas_trsm.py``
(``pallas_trsm_batch`` / ``trsm_tiles_body``); the source is
``csrc/trsm.cu``.  By the count it is bound by bytes (about 2.5 tiles moved
for nb·kv² operations); in practice by the latency of the chain of ``kv``
dependent column steps, since most levels have fewer pairs than the card
has SMs.  Its design is the factor stream kernel's TRSM item
(``csrc/mega_factor_body.cuh``): one block takes a band of 16, 32 or 64 dst
rows of one pair (:func:`trsm_band_rows`: the fewer pairs, the narrower
the bands, so that a level with few pairs spreads over more blocks),
stages L^T and its rows in shared memory and eliminates in panels of 16
columns, one thread a row in registers, then a register-tiled rank-16
product.  Where L^T does not fit beside the rows (nb = 256) it is staged a
panel at a time.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, load, require_cuda_tensors

__all__ = ["trsm", "trsm_plain", "trsm_band_rows", "trsm_bands"]

# Rows of the widest band and the blocks a launch is spread over (two on
# each of the H100's 132 SMs); csrc/trsm.cu band_rows states the same rule.
BAND_ROWS, BAND_BLOCKS = 64, 264

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {f"spllt_trsm_{s}": [_P, _P, _P, _P, _I, _I, _P]
        for s in ("f32", "f64")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def trsm_band_rows(npairs: int, nb: int) -> int:
    """Rows of each band the kernel cuts a pair into, for a launch of
    ``npairs`` pairs: 16, 32 or 64, the narrowest that keeps the launch's
    blocks within ``BAND_BLOCKS`` (never more than nb)."""
    items = npairs * -(-nb // BAND_ROWS)
    rows = (BAND_ROWS // 4 if 4 * items <= BAND_BLOCKS else
            BAND_ROWS // 2 if 2 * items <= BAND_BLOCKS else BAND_ROWS)
    return min(rows, nb)


def trsm_bands(npairs: int, nb: int) -> list:
    """The kernel's blocks for a launch of ``npairs`` pairs: (pair, first
    dst row, rows) each, in block order."""
    rows = trsm_band_rows(npairs, nb)
    return [(p, r0, min(rows, nb - r0)) for p in range(npairs)
            for r0 in range(0, nb, rows)]


def trsm_plain(diag: torch.Tensor, dst: torch.Tensor,
               kvec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device): library triangular solve against
    the identity-padded diag tile, columns >= kvec zeroed."""
    nb = dst.shape[-1]
    dev = dst.device
    k = kvec.to(torch.int64).view(-1, 1, 1)
    ar = torch.arange(nb, device=dev)
    rowi, coli = ar.view(1, nb, 1), ar.view(1, 1, nb)
    c = diag + ((rowi == coli) & (rowi >= k)).to(dst.dtype)
    x = torch.linalg.solve_triangular(c.transpose(-1, -2), dst, upper=True,
                                      left=False)
    return (x * (coli < k).to(dst.dtype)).contiguous()


def trsm(diag: torch.Tensor, dst: torch.Tensor,
         kvec: torch.Tensor) -> torch.Tensor:
    """diag, dst [K, nb, nb] float32/float64, kvec [K] int32, one device.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if dst.device.type == "cpu":
        return trsm_plain(diag, dst, kvec)
    require_cuda_tensors("trsm", dst, diag, kvec)
    if dst.ndim != 3 or dst.shape[1] != dst.shape[2] \
            or diag.shape != dst.shape or kvec.shape != (dst.shape[0],):
        raise ValueError(f"trsm: bad shapes {tuple(diag.shape)}, "
                         f"{tuple(dst.shape)}, {tuple(kvec.shape)}")
    if dst.dtype not in _SUFFIX or diag.dtype != dst.dtype \
            or kvec.dtype != torch.int32:
        raise ValueError(f"trsm: unsupported dtypes {diag.dtype}, "
                         f"{dst.dtype}, {kvec.dtype}")
    out = torch.empty_like(dst)
    if dst.shape[0] == 0:
        return out
    fn = getattr(load("trsm", _SIG), "spllt_trsm_" + _SUFFIX[dst.dtype])
    with torch.cuda.device(dst.device):
        status = fn(diag.data_ptr(), dst.data_ptr(), out.data_ptr(),
                    kvec.data_ptr(), dst.shape[0], dst.shape[1],
                    torch.cuda.current_stream().cuda_stream)
    check_launch(status, "trsm")
    trsm.launches += 1
    return out


trsm.launches = 0
