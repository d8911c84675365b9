"""The least time the card could take for a factorization and for a refined
solve, from the work a configuration's matrix needs.

The counts are frozen in the configuration's file (``work``, written once by
``count_work.py`` from the program's analysis): a change that fuses launches,
adds a kernel or moves work between kernels reads the same bound.  Each
input byte is read once and each output byte written once.
"""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def card_peaks(device_name: str):
    """The peak rates of the card named ``device_name`` (None when the table
    has no entry whose key is part of the name)."""
    with open(PEAKS_FILE) as f:
        cards = json.load(f)["cards"]
    for key, peaks in cards.items():
        if key in device_name:
            return peaks
    return None


def factor_bound_s(work: dict, peaks: dict) -> float:
    """max(flops / the configuration's flop peak, bytes / HBM bandwidth):
    the factor's flops, and the float32 factor written and A's values read
    (4 bytes each)."""
    flops = work["flops"] / peaks[work["flop_peak"] + "_flop_per_s"]
    nbytes = 4 * (work["nnz_l"] + work["nnz_a"])
    return max(flops, nbytes / peaks["hbm_bytes_per_s"])


def solve_bytes(work: dict, refine: int, nrhs: int) -> int:
    """Bytes of a solve refined ``refine`` times on ``nrhs`` columns: the
    float32 factor read twice (forward, backward) by each of the refine + 1
    solves; per refinement step A's float64 values and int32 column ids in
    the residual's product; the vectors: each sweep reads and writes the
    float32 right-hand side, each step reads x and b and writes the float64
    residual and x."""
    n, k = work["n"], nrhs
    factor = 2 * (refine + 1) * 4 * work["nnz_l"]
    matvec = refine * 12 * work["nnz_a_full"]
    vectors = (refine + 1) * 2 * 2 * 4 * n * k + refine * 4 * 8 * n * k
    return factor + matvec + vectors


def solve_bound_s(work: dict, peaks: dict, refine: int, nrhs: int) -> float:
    """The refined solve is bound by bandwidth: its bytes over HBM's rate."""
    return solve_bytes(work, refine, nrhs) / peaks["hbm_bytes_per_s"]
