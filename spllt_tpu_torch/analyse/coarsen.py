"""Dense subtree coarsening for the batched executor.

A copy of ``spllt_tpu.analyse.coarsen`` (the parity tests hold the two
equal).  A re-design of the reference's pruned-subtree path
(``spllt_subtree_factorize``: a whole subtree executes as ONE task with a
generated-element buffer, SpLLT:src/spllt_kernels_mod.F90:780-821
and spllt_factorization_mod.F90:39-261).  Here small subtrees become
*dense frontal problems*: the subtree's columns V plus its boundary rows B
form a dense matrix factored by one batched partial Cholesky — hundreds of
subtrees in one batched kernel launch, replacing thousands of tiny leaf tasks.  The
factored columns scatter back into the block pool, so the surviving
between-updates into nodes above the coarse layer need no new machinery.

Zero-fill positions inside the dense front factor to exact zeros (no fill
path ⇒ the dense recurrence computes 0 - 0·x), so the embedded sparse
factor is recovered exactly; the cost is the dense-over-sparse flop waste,
bounded by ``waste``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CoarseSubtrees", "coarse_partition"]


@dataclasses.dataclass
class CoarseSubtrees:
    nsub: int
    sub_of_node: np.ndarray     # node -> subtree id or -1
    root: np.ndarray            # [nsub] root node
    node_lo: np.ndarray         # [nsub] first node (contiguous range)
    v_lo: np.ndarray            # [nsub] first column
    v_hi: np.ndarray            # [nsub] last column (inclusive)
    bptr: np.ndarray            # [nsub+1] into brows
    brows: np.ndarray           # concatenated sorted boundary rows
    span: np.ndarray            # [nsub] |V| + |B|

    def boundary(self, s: int) -> np.ndarray:
        return self.brows[self.bptr[s]:self.bptr[s + 1]]


def coarse_partition(forest, node_flops: np.ndarray, max_span: int = 256,
                     waste: float = 8.0) -> CoarseSubtrees:
    """Greedy bottom-up coarsening.

    A maximal subtree is coarsened when its dense span (|V|+|B|) fits
    ``max_span`` and the dense partial-factorization flops
    span²·|V| stay within ``waste`` × the subtree's true flops.
    """
    nnodes = forest.nnodes
    sub_of_node = np.full(nnodes, -1, dtype=np.int64)
    children: list[list[int]] = [[] for _ in range(nnodes)]
    for nd in range(nnodes):
        p = forest.sparent[nd]
        if p != -1:
            children[p].append(nd)

    # subtree aggregates, computed bottom-up (postorder = ascending ids)
    sub_flops = node_flops.astype(np.float64).copy()
    ndesc = np.zeros(nnodes, dtype=np.int64)
    feasible = np.zeros(nnodes, dtype=bool)
    span_of = np.zeros(nnodes, dtype=np.int64)
    for nd in range(nnodes):
        for c in children[nd]:
            sub_flops[nd] += sub_flops[c]
            ndesc[nd] += ndesc[c] + 1
        v_lo = forest.sa[nd - ndesc[nd]]
        ncols_sub = int(forest.en[nd] - v_lo + 1)
        rows_nd = forest.node_rows(nd)
        nbound = int(np.sum(rows_nd > forest.en[nd]))
        # boundary of the subtree rooted at nd == boundary of nd itself:
        # every interior node's outside rows are ⊆ root rows ∪ root cols
        span = ncols_sub + nbound
        span_of[nd] = span
        dense_flops = float(span) * span * ncols_sub
        feasible[nd] = (span <= max_span
                        and dense_flops <= waste * max(1.0, sub_flops[nd]))

    # pick maximal feasible subtrees top-down
    roots = [nd for nd in range(nnodes) if forest.sparent[nd] == -1]
    chosen: list[int] = []
    stack = list(roots)
    while stack:
        nd = stack.pop()
        if feasible[nd]:
            chosen.append(nd)
        else:
            stack.extend(children[nd])
    chosen.sort()

    nsub = len(chosen)
    root = np.asarray(chosen, dtype=np.int64)
    node_lo = root - ndesc[root]
    v_lo = forest.sa[node_lo]
    v_hi = forest.en[root]
    b_lists = []
    for s, r in enumerate(chosen):
        rows_r = forest.node_rows(int(r))
        b = rows_r[rows_r > forest.en[r]]
        b_lists.append(b)
        sub_of_node[node_lo[s]:r + 1] = s
    bptr = np.zeros(nsub + 1, dtype=np.int64)
    bptr[1:] = np.cumsum([len(b) for b in b_lists])
    brows = (np.concatenate(b_lists) if nsub
             else np.empty(0, dtype=np.int64))
    span = (v_hi - v_lo + 1) + np.diff(bptr)
    if __debug__:
        for s in range(nsub):
            assert span[s] == span_of[root[s]]
    return CoarseSubtrees(nsub=nsub, sub_of_node=sub_of_node, root=root,
                          node_lo=node_lo, v_lo=v_lo, v_hi=v_hi,
                          bptr=bptr, brows=brows, span=span)
