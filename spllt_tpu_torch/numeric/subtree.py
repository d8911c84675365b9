"""Batched dense subtree factorization (coarse-leaf phase).

Executes the plan's dense phase (``plan/factor_tasks._build_dense_phase``,
``Options(coarse_subtrees=True)``): per spad bucket, gather the fronts
[nsub, spad, spad] from the assembled pool, run ONE batched partial
Cholesky — the leading |V| columns of each front and the boundary rows
below them — and write the factored columns back into the pool's tiles.
It replaces the reference's per-subtree sequential
``spllt_subtree_factorize`` tasks with one kernel launch per size bucket;
the factor executor that follows treats the written tiles as factored.

``subtree_np`` is a copy of ``spllt_tpu.numeric.subtree.subtree_np``, the
float64 NumPy oracle (it assembles the fronts from the matrix values).
:class:`DenseSubtreeExecutor` is the device version.  Its gathers and
stores are exact index loads and stores; the partial Cholesky is the
batched potrf kernel (:mod:`.hopper_potrf`, K1), whose bordered
elimination is exactly a front's partial factorization.  Left behind from
the JAX package's executor, as TPU workarounds: the one-hot contractions
that moved data on the matrix unit and their chunking, the padding of
spad to a multiple of 128 and the padding of the front count to a group.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..errors import NotPositiveDefiniteError
from .factor_scan import canonical_device
from . import hopper_potrf

__all__ = ["subtree_np", "DenseSubtreeExecutor"]


# ===================================================================== #
# NumPy oracle
# ===================================================================== #
def subtree_np(pool: np.ndarray, values: np.ndarray, fp) -> np.ndarray:
    nb = fp.nb
    for b in fp.dense or []:
        sp = b["spad"]
        ns = b["nsub"]
        f = np.zeros((ns, sp, sp))
        np.add.at(f, (b["asm_sub"], b["asm_r"], b["asm_c"]),
                  values[b["asm_vidx"]])
        for i in range(ns):
            k = int(b["kvec"][i])
            d = f[i][:k, :k]
            d = np.tril(d) + np.tril(d, -1).T
            try:
                ld = np.linalg.cholesky(d)
            except np.linalg.LinAlgError as e:
                raise NotPositiveDefiniteError(
                    f"dense front {i} not positive definite") from e
            below = f[i][k:, :k]
            out = np.zeros((sp, sp))
            out[:k, :k] = ld
            out[k:, :k] = sla.solve_triangular(ld, below.T, lower=True).T
            f[i] = out
        for j in range(len(b["sc_blk"])):
            rp, rv = b["sc_rpos"][j], b["sc_rval"][j]
            cp, cv = b["sc_cpos"][j], b["sc_cval"][j]
            tile = np.zeros((nb, nb))
            tile[np.ix_(rv, cv)] = f[b["sc_sub"][j]][rp[rv]][:, cp[cv]]
            pool[b["sc_blk"][j]] = tile
    return pool


# ===================================================================== #
# device executor
# ===================================================================== #
class DenseSubtreeExecutor:
    """The dense phase of one FactorPlan on ``device``.

    Per bucket the tables hold, for every pool tile of a coarsened node,
    its block id, its front, and the front row of each tile row and the
    front column of each tile column.  Rows and columns a tile does not
    use point at index spad: a front is held as [spad+1, spad+1] while it
    is gathered and written back, and that last row and column are a dump
    on the way in and zeros on the way out, so every gather and store is
    a plain indexed one with no mask.  The tables do not depend on the
    values; one executor serves every refactorization of the pattern.

    Each bucket's ``launches`` counts the potrf kernel launches its fronts
    were given, read from the wrapper's own count around the call (so it
    stays 0 where the wrapper runs its plain version, on the CPU).
    """

    # tiles moved per indexed gather or store: bounds the temporaries
    # (the tiles and their int64 element indices) at ≈ 2**25 elements
    _CHUNK_ELEMS = 1 << 25

    def __init__(self, fp, device="cuda"):
        self.nb = nb = fp.nb
        self.device = dev = canonical_device(device)
        self.buckets = []
        for b in fp.dense or []:
            sp = int(b["spad"])
            rpos = np.where(b["sc_rval"], b["sc_rpos"], sp)
            cpos = np.where(b["sc_cval"], b["sc_cpos"], sp)
            i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                            device=dev)
            self.buckets.append(dict(
                spad=sp, nsub=int(b["nsub"]), launches=0,
                kvec=torch.as_tensor(np.asarray(b["kvec"], np.int32),
                                     device=dev),
                blk=i64(b["sc_blk"]), sub=i64(b["sc_sub"]).view(-1, 1, 1),
                rpos=i64(rpos).view(-1, nb, 1),
                cpos=i64(cpos).view(-1, 1, nb)))

    def chunks(self, t: dict):
        """Slices of a bucket's tiles, one indexed gather or store each."""
        step = max(1, self._CHUNK_ELEMS // (self.nb * self.nb))
        nblk = t["blk"].shape[0]
        return [slice(s, min(nblk, s + step)) for s in range(0, nblk, step)]

    def fronts(self, pool: torch.Tensor, t: dict) -> torch.Tensor:
        """The bucket's fronts [nsub, spad, spad], gathered from the
        assembled pool (the dense phase's input to the potrf kernel)."""
        sp = t["spad"]
        ext = pool.new_zeros((t["nsub"], sp + 1, sp + 1))
        for c in self.chunks(t):
            ext[t["sub"][c], t["rpos"][c], t["cpos"][c]] = pool[t["blk"][c]]
        return ext[:, :sp, :sp].contiguous()

    def scatter(self, pool: torch.Tensor, t: dict, lf: torch.Tensor):
        """Write the factored fronts ``lf`` back into the bucket's tiles,
        whole: the positions a tile does not use become zero."""
        sp = t["spad"]
        ext = lf.new_zeros((t["nsub"], sp + 1, sp + 1))
        ext[:, :sp, :sp] = lf
        for c in self.chunks(t):
            pool[t["blk"][c]] = ext[t["sub"][c], t["rpos"][c], t["cpos"][c]]

    def __call__(self, pool: torch.Tensor):
        """pool: the assembled [nblocks+1, nb, nb] pool on the executor's
        device; the coarsened nodes' tiles are factored IN PLACE.  Returns
        (pool, not_posdef_flag): the flag is a 0-d bool tensor, true when a
        front was not positive definite (the potrf kernel, and its plain
        version, return such a front as NaN everywhere)."""
        if pool.device != self.device or not pool.is_contiguous():
            raise ValueError(f"pool must be contiguous on {self.device}, "
                             f"got {pool.device}")
        bad = torch.zeros((), dtype=torch.bool, device=pool.device)
        for t in self.buckets:
            before = hopper_potrf.potrf.launches
            lf = hopper_potrf.potrf(self.fronts(pool, t), t["kvec"])
            t["launches"] += hopper_potrf.potrf.launches - before
            bad = bad | torch.isnan(lf[:, 0, 0]).any()
            self.scatter(pool, t, lf)
        return pool, bad
