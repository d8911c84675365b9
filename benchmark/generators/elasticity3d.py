"""The pattern of 3-D linear elasticity on trilinear hexahedra (Q1) over an
m × m × m node grid, ``dofs`` displacement unknowns a node: the structural
finite-element class of SuiteSparse ``GHS_psdef/audikw_1`` (3 dofs a node,
81 nonzeros in an interior row).

The benchmark's own frozen copy: a change to the program's generators
cannot move the inputs.  Node (i, j, k) is g = i·m² + j·m + k and its dof d
is row dofs·g + d.  Two nodes are coupled when |Δi|, |Δj|, |Δk| ≤ 1 (they
share an element), and every dof pair of two coupled nodes is a nonzero: a
full dofs × dofs block.  Off-diagonals are −1 and the diagonal is the
off-diagonal count of an interior row (27·dofs − 1), so interior rows have
margin 0 and boundary rows a positive one (Dirichlet): irreducibly
diagonally dominant, so SPD, conditioned as a Laplacian.  Lower-triangle
CSC, rows sorted in each column.
"""

import numpy as np


def make(params: dict):
    """(n, colptr, rowind, values) of the matrix that ``params`` names:
    ``{"m": m, "dofs": dofs}``."""
    m, dofs = int(params["m"]), int(params["dofs"])
    nn = m ** 3
    n = nn * dofs
    g = np.arange(nn, dtype=np.int64)
    k, j, i = g % m, (g // m) % m, g // (m * m)
    # the node itself, then the 13 neighbours of larger number, in
    # increasing node order
    steps = [(0, 0, 0)] + [(a, b, c) for a in (0, 1) for b in (-1, 0, 1)
                           for c in (-1, 0, 1) if (a, b, c) > (0, 0, 0)]
    nbr = np.empty((nn, len(steps)), dtype=np.int64)
    has = np.empty((nn, len(steps)), dtype=bool)
    for s, (a, b, c) in enumerate(steps):
        nbr[:, s] = g + a * m * m + b * m + c
        has[:, s] = ((0 <= i + a) & (i + a < m) & (0 <= j + b) & (j + b < m)
                     & (0 <= k + c) & (k + c < m))
    e = np.arange(dofs, dtype=np.int64)
    # candidate rows of column dofs·g + d: [nn, dofs (d), slots, dofs (e)]
    rows = np.broadcast_to((dofs * nbr[:, :, None] + e)[:, None],
                           (nn, dofs, len(steps), dofs))
    keep = np.broadcast_to(has[:, None, :, None], rows.shape).copy()
    keep[:, :, 0, :] = e[None, :] >= e[:, None]     # own node: rows d' ≥ d
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.reshape(n, -1).sum(1), out=colptr[1:])
    rowind = rows[keep]
    del keep
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(colptr))
    values = np.where(rowind == cols, 27.0 * dofs - 1.0, -1.0)
    return n, colptr, rowind, values
