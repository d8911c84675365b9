"""7-point Poisson matrix on an m × m × m grid (Dirichlet boundary), the
matrix of SpLLT's ``aux/run_tests_poisson3d.sh`` sweep.

The benchmark's own frozen copy: a change to the program's generators
cannot move the inputs.  Lower-triangle CSC, rows sorted in each column,
grid point (i, j, k) numbered i·m² + j·m + k; diagonal 6, each of the up
to six neighbours −1.
"""

import numpy as np


def make(params: dict):
    """(n, colptr, rowind, values) of the matrix that ``params`` names:
    ``{"m": m}``."""
    m = int(params["m"])
    n = m ** 3
    g = np.arange(n, dtype=np.int64)
    k, j, i = g % m, (g // m) % m, g // (m * m)
    # lower neighbours of column g, in increasing row order
    steps = ((1, k < m - 1), (m, j < m - 1), (m * m, i < m - 1))
    count = 1 + sum(has.astype(np.int64) for _, has in steps)
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(count, out=colptr[1:])
    rowind = np.empty(int(colptr[-1]), dtype=np.int64)
    values = np.full(len(rowind), -1.0)
    pos = colptr[:-1].copy()
    rowind[pos] = g
    values[pos] = 6.0
    pos += 1
    for d, has in steps:
        rowind[pos[has]] = g[has] + d
        pos[has] += 1
    return n, colptr, rowind, values
