"""Batched left triangular solve of right-hand-side panels.

``left_solve(tiles, z, kvec, transpose)``: per tile, with
``m = tile + I on the diagonal of rows >= kvec``, solves ``m y = z``
(``transpose=False``) or ``mᵀ y = z`` (``transpose=True``) for
z [K, nb, nrhs].  In the forward sweep the rows >= kvec of the tile carry
real ``B·L^-T`` values, so the solve applies the below-row update in
passing; in the transposed sweep those rhs rows pass through unchanged.
``nrhs`` is arbitrary.

Kernel note.  Replaces the TPU kernel ``spllt_tpu/numeric/pallas_solve.py``
(``pallas_left_solve`` / ``solve_tiles_body``); the source is
``csrc/solve.cu`` with its body ``csrc/solve_body.cuh``.  Bound by bytes
at small nrhs (a tile is read once for 2·nb·kv·nrhs operations), but a
launch lasts the latency of its tiles' chains of dependent steps.  One
thread block per (tile, chunk of ≤ 64 rhs columns) stages the tile's
trapezoid and the chunk in shared memory by asynchronous 16-byte copies
and solves in panels of 32 columns: the panel's diagonal block in one
warp's registers (reciprocal pivots, shuffles), then a register-tiled
product for the rows below (above) it — two block barriers a panel.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, load, require_cuda_tensors

__all__ = ["left_solve", "left_solve_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {f"spllt_left_solve_{s}": [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        for s in ("f32", "f64")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def left_solve_plain(tiles: torch.Tensor, z: torch.Tensor,
                     kvec: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Plain PyTorch version (any device): library triangular solve against
    the identity-padded tile (lower triangle only is read)."""
    nb = tiles.shape[-1]
    dev = tiles.device
    k = kvec.to(torch.int64).view(-1, 1, 1)
    ar = torch.arange(nb, device=dev)
    rowi, coli = ar.view(1, nb, 1), ar.view(1, 1, nb)
    m = tiles + ((rowi == coli) & (rowi >= k)).to(tiles.dtype)
    if transpose:
        y = torch.linalg.solve_triangular(m.transpose(-1, -2), z, upper=True)
    else:
        y = torch.linalg.solve_triangular(m, z, upper=False)
    return y.contiguous()


def left_solve(tiles: torch.Tensor, z: torch.Tensor, kvec: torch.Tensor,
               transpose: bool) -> torch.Tensor:
    """tiles [K, nb, nb], z [K, nb, nrhs] float32/float64, kvec [K] int32,
    one device.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if tiles.device.type == "cpu":
        return left_solve_plain(tiles, z, kvec, transpose)
    require_cuda_tensors("left_solve", tiles, z, kvec)
    if tiles.ndim != 3 or tiles.shape[1] != tiles.shape[2] or z.ndim != 3 \
            or z.shape[:2] != tiles.shape[:2] \
            or kvec.shape != (tiles.shape[0],):
        raise ValueError(f"left_solve: bad shapes {tuple(tiles.shape)}, "
                         f"{tuple(z.shape)}, {tuple(kvec.shape)}")
    if tiles.dtype not in _SUFFIX or z.dtype != tiles.dtype \
            or kvec.dtype != torch.int32:
        raise ValueError(f"left_solve: unsupported dtypes {tiles.dtype}, "
                         f"{z.dtype}, {kvec.dtype}")
    y = torch.empty_like(z)
    if z.numel() == 0:
        return y
    fn = getattr(load("solve", _SIG),
                 "spllt_left_solve_" + _SUFFIX[tiles.dtype])
    with torch.cuda.device(tiles.device):
        status = fn(tiles.data_ptr(), z.data_ptr(), y.data_ptr(),
                    kvec.data_ptr(), tiles.shape[0], tiles.shape[1],
                    z.shape[2], int(bool(transpose)),
                    torch.cuda.current_stream().cuda_stream)
    check_launch(status, "left_solve")
    left_solve.launches += 1
    return y


left_solve.launches = 0
