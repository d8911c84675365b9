"""Persistence of symbolic and numeric factors (checkpoint/resume).

The reference has no checkpointing (SURVEY §5: 'none; the closest
analogue is the persistent akeep/fkeep split').  Here both objects
serialize to a single ``.npz``: the symbolic factor (pattern analysis is
expensive for large problems) and, optionally, the numeric factor pool —
so a service can analyse once, checkpoint, and refactor/solve from the
checkpoint across processes.

The files are those of ``spllt_tpu.utils.persist`` — the same ``.npz`` keys
and the same saved option fields — so a checkpoint written by either
package loads in the other.  Two things differ: ``save_factor`` copies a
device pool to the host first, and the loaders take the ``device`` the
numeric work runs on (None means the card, as ``Options(device=None)``);
``load_factor`` uploads the pool there in its own dtype.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_symbolic", "load_symbolic", "save_factor", "load_factor"]

_OPT_FIELDS = ("nb", "nemin", "ordering", "grid_shape", "prune_tree",
               "mode", "schedule", "dtype", "precision", "refine",
               "ndevices", "solve_group")


def save_symbolic(path: str, symb) -> None:
    opt = {"options": np.array(
        [{k: getattr(symb.options, k) for k in _OPT_FIELDS}], dtype=object)}
    np.savez_compressed(
        path,
        n=symb.n, perm=symb.perm,
        a_colptr=symb.a_perm.colptr, a_rowind=symb.a_perm.rowind,
        a_values=(symb.a_perm.values if symb.a_perm.values is not None
                  else np.empty(0)),
        f_nnodes=symb.forest.nnodes, f_sa=symb.forest.sa,
        f_en=symb.forest.en, f_sparent=symb.forest.sparent,
        f_rptr=symb.forest.rptr, f_rows=symb.forest.rows,
        weight=symb.weight, node_flops=symb.node_flops, small=symb.small,
        inform_maxdepth=symb.inform.maxdepth,
        inform_num_factor=symb.inform.num_factor,
        inform_num_flops=symb.inform.num_flops,
        inform_num_nodes=symb.inform.num_nodes,
        **opt,
    )


def load_symbolic(path: str, device: str | None = None):
    """The SymbolicFactor saved at ``path``; its options take ``device``."""
    from ..analyse.analyse import SymbolicFactor
    from ..analyse.supernodes import SupernodeForest
    from ..inform import Inform
    from ..options import Options
    from ..sparse.csc import CscMatrix

    z = np.load(path, allow_pickle=True)
    opts = dict(z["options"][0])
    if opts.get("grid_shape") is not None:
        opts["grid_shape"] = tuple(int(x) for x in opts["grid_shape"])
    # drop fields saved by older versions that no longer exist
    known = {f.name for f in __import__("dataclasses").fields(Options)}
    opts = {k: v for k, v in opts.items() if k in known}
    options = Options(**opts, device=device)
    vals = z["a_values"]
    a = CscMatrix(int(z["n"]), z["a_colptr"], z["a_rowind"],
                  vals if len(vals) else None)
    forest = SupernodeForest(
        nnodes=int(z["f_nnodes"]), sa=z["f_sa"], en=z["f_en"],
        sparent=z["f_sparent"], rptr=z["f_rptr"], rows=z["f_rows"])
    inform = Inform(
        maxdepth=int(z["inform_maxdepth"]),
        num_factor=int(z["inform_num_factor"]),
        num_flops=int(z["inform_num_flops"]),
        num_nodes=int(z["inform_num_nodes"]))
    return SymbolicFactor(
        n=int(z["n"]), perm=z["perm"], a_perm=a, forest=forest,
        weight=z["weight"], node_flops=z["node_flops"], small=z["small"],
        inform=inform, options=options)


def save_factor(path: str, num) -> None:
    """Checkpoint the numeric factor (symbolic + factored pool; of the
    forest path, its global pool)."""
    import torch

    pool = num.pool
    if num.mdf is not None:
        from ..convert import numeric_to_numpy

        pool = numeric_to_numpy(num)[0]
    elif isinstance(pool, torch.Tensor):
        pool = pool.cpu().numpy()
    save_symbolic(path + ".symb.npz", num.symb)
    np.savez_compressed(path, pool=pool, values_perm=num.values_perm)


def load_factor(path: str, device: str | None = None):
    """Rebuild a solvable NumericFactor from a checkpoint.  In batched mode
    the pool goes to ``device`` in the dtype it was saved in, and the factor
    shares the symbolic object's solve-executor cache, as one made by
    ``factor`` does; an ``stf`` pool stays a NumPy array.  With
    ``ndevices`` > 1 the pool is spread over the devices of the forest
    path."""
    import dataclasses

    import torch

    from ..api import (NumericFactor, _exec_key, _forest_run, _plans,
                       _resolve_device)

    symb = load_symbolic(path + ".symb.npz", device=device)
    options = symb.options
    z = np.load(path)
    if _forest_run(options):
        from ..convert import numeric_from_numpy

        return numeric_from_numpy(symb, z["pool"], z["values_perm"], options)
    plan, fplan, splan = _plans(symb, options)
    inform = dataclasses.replace(symb.inform)
    inform.num_blocks = plan.nblocks
    inform.num_levels = fplan.nlevels
    inform.num_tasks = fplan.num_tasks
    pool, solve_execs = z["pool"], {}
    if options.mode == "batched":
        dev = _resolve_device(options)
        pool = torch.as_tensor(pool, device=dev)
        solve_execs = symb._cache.setdefault(_exec_key("sex", options, dev),
                                             {})
    return NumericFactor(
        symb=symb, plan=plan, fplan=fplan, splan=splan,
        pool=pool, values_perm=z["values_perm"],
        options=options, inform=inform, _solve_execs=solve_execs)
