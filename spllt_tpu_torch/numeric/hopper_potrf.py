"""Batched masked bordered Cholesky (potrf) of diagonal tiles.

``potrf(tiles, kvec)``: tiles [K, nb, nb] whose leading ``kvec`` columns
hold the (lower) diagonal block D and whose rows >= kvec hold boundary rows
B; returns ``[[chol(D), 0], [B·chol(D)^-T, 0]]``.  A tile whose Cholesky
fails comes back as NaN, never as an exception, so both routes meet the
caller's not-positive-definite guard.

Kernel note.  Replaces the TPU kernel ``spllt_tpu/numeric/pallas_potrf.py``
(``pallas_potrf_batch`` / ``potrf_tiles_body``); the source is
``csrc/potrf.cu`` with its body ``csrc/potrf_body.cuh``.  On the card the
leaf levels (thousands of tiles with a handful of factor columns) are bound
by bytes: a tile is written once and only the lower trapezoid of its
columns < ``kv`` is read.  The top levels (few tiles, ``kv`` = nb) are held
back by the latency of the chain of ``kv`` dependent columns.  One thread
block per tile, built from the pieces of the factor stream kernel's POTRF
item (``csrc/mega_factor_body.cuh``): the trapezoid staged in shared memory
by 16-byte ``cp.async.cg`` (in place on the output tile in global memory /
L2 when nb·nb elements exceed what a block may use, as at nb = 256 in
float32), panels of 16 columns — one warp factors the diagonal block in
registers with ``rsqrt``, one thread a row solves the rows below, and a
register-tiled rank-16 product updates the trapezoid right of the panel.
A failed pivot turns the whole tile into NaN.  The batch supplies the
parallelism across the SMs.  float32 and float64 share one template.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, load, require_cuda_tensors

__all__ = ["potrf", "potrf_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {f"spllt_potrf_{s}": [_P, _P, _P, _I, _I, _P] for s in ("f32", "f64")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def potrf_plain(tiles: torch.Tensor, kvec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device): library Cholesky of the
    symmetrized, identity-padded diagonal block plus a triangular solve of
    the rows below."""
    nb = tiles.shape[-1]
    dev = tiles.device
    k = kvec.to(torch.int64).view(-1, 1, 1)
    ar = torch.arange(nb, device=dev)
    rowi, coli = ar.view(1, nb, 1), ar.view(1, 1, nb)
    zero = torch.zeros((), dtype=tiles.dtype, device=dev)
    in_d = (rowi < k) & (coli < k)
    low = torch.where(in_d & (rowi >= coli), tiles, zero)
    sym = low + torch.where(in_d & (rowi > coli), tiles,
                            zero).transpose(-1, -2)
    pad_eye = ((rowi == coli) & (rowi >= k)).to(tiles.dtype)
    c, info = torch.linalg.cholesky_ex(sym + pad_eye)
    below = torch.where(rowi >= k, tiles, zero)
    bp = torch.linalg.solve_triangular(c.transpose(-1, -2), below,
                                       upper=True, left=False)
    out = torch.where(rowi < k, c, bp) * (coli < k).to(tiles.dtype)
    bad = (info != 0).view(-1, 1, 1) | torch.isnan(c).any(-1).any(-1).view(
        -1, 1, 1)
    return torch.where(bad, torch.full_like(zero, float("nan")),
                       out).contiguous()


def potrf(tiles: torch.Tensor, kvec: torch.Tensor) -> torch.Tensor:
    """tiles [K, nb, nb] float32/float64, kvec [K] int32 on the same device.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if tiles.device.type == "cpu":
        return potrf_plain(tiles, kvec)
    require_cuda_tensors("potrf", tiles, kvec)
    if tiles.ndim != 3 or tiles.shape[1] != tiles.shape[2] \
            or kvec.shape != (tiles.shape[0],):
        raise ValueError(f"potrf: bad shapes {tuple(tiles.shape)}, "
                         f"{tuple(kvec.shape)}")
    if tiles.dtype not in _SUFFIX or kvec.dtype != torch.int32:
        raise ValueError(f"potrf: unsupported dtypes {tiles.dtype}, "
                         f"{kvec.dtype}")
    out = torch.empty_like(tiles)
    if tiles.shape[0] == 0:
        return out
    fn = getattr(load("potrf", _SIG), "spllt_potrf_" + _SUFFIX[tiles.dtype])
    with torch.cuda.device(tiles.device):
        status = fn(tiles.data_ptr(), out.data_ptr(), kvec.data_ptr(),
                    tiles.shape[0], tiles.shape[1],
                    torch.cuda.current_stream().cuda_stream)
    check_launch(status, "potrf")
    potrf.launches += 1
    return out


potrf.launches = 0
