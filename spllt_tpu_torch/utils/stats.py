"""Plan statistics.

Analogue of ``spllt_tree_stat_mod`` (dependency-count statistics,
SpLLT:src/spllt_tree_stat_mod.F90) extended with the numbers that matter
for a statically scheduled program: level-width distribution and per-kind
task/flop breakdowns.  Printed by the CLI with --stats.

A copy of ``spllt_tpu.utils.stats`` without its ``buckets`` argument: the
level bucketing it reports on (``spllt_tpu/plan/buckets.py``) bounds the
compile time of the JAX package's ``lax.scan`` executors and has no
counterpart here.  The output is the JAX package's for ``buckets=None``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["factor_plan_stats", "print_stats"]


def factor_plan_stats(fp) -> dict:
    counts = fp.level_counts()
    widths = {k: (int(v.max()) if len(v) else 0) for k, v in counts.items()}
    total = {k: int(v.sum()) for k, v in counts.items()}
    nb = fp.nb
    updbt_width = int(fp.updbt_c.sum()) if len(fp.updbt_c) else 0
    flops = {
        "potrf": total["potrf"] * nb ** 3 / 3,
        "trsm": total["trsm"] * nb ** 3,
        "syrk": total["syrk"] * 2 * nb ** 3,
        "updbt": updbt_width * 2 * nb ** 3,  # width-fused tasks
    }
    out = {
        "nlevels": fp.nlevels,
        "nblocks": fp.nblocks,
        "num_tasks": fp.num_tasks,
        "tasks_per_kind": total,
        "max_level_width": widths,
        "mean_level_width": {
            k: float(v.sum()) / max(1, fp.nlevels)
            for k, v in counts.items()},
        "nominal_flops_per_kind": flops,
        "num_maps": int(fp.maps.shape[0]),
        "map_bytes": int(fp.maps.nbytes),
    }
    return out


def print_stats(stats: dict, out=None) -> str:
    lines = []
    for k, v in stats.items():
        lines.append(f"{k:>24}: {v}")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
