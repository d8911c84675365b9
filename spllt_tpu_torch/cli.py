"""Command-line driver.

Mirrors the reference drivers (drivers/spllt_omp.F90,
drivers/spllt_new_test.F90) and CLI parser ``spllt_parse_args``
(SpLLT:src/spllt_mod.F90:328-421): read or generate a matrix,
analyse/factor/solve, report residuals, timings and stats.

    python -m spllt_tpu_torch --mm matrix.mtx --nb 256 --nemin 32 --nrhs 4
    python -m spllt_tpu_torch --poisson3d 32 --nb 128 --schedule mega
    python -m spllt_tpu_torch --poisson2d 12 --nb 8 --device cpu --json

The flags, defaults, output lines, ``--json`` keys and exit codes of
``python -m spllt_tpu`` (``spllt_tpu/cli.py``), plus ``--device``: where the
batched numeric work runs (the card unless ``cpu`` is asked for).
``--ndev k`` (k > 1) runs the forest path on k cards from ``--device`` on
(``cuda:N … cuda:N+k-1``), or on k shards on the CPU with ``--device cpu``;
``--mode stf`` ignores it.  Exit code 0 when the backward error is below
1e-4, 1 otherwise, and 2 when the run cannot be made as asked: a CUDA
device, or k of them, that is not there — never a run somewhere else
instead.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spllt_tpu_torch",
        description="supernodal sparse Cholesky solver on NVIDIA GPUs "
                    "(PyTorch/CUDA)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--mat", help="Rutherford-Boeing matrix file")
    src.add_argument("--mm", help="MatrixMarket matrix file")
    src.add_argument("--poisson2d", type=int, metavar="M",
                     help="generate M×M 5-point Poisson matrix")
    src.add_argument("--poisson3d", type=int, metavar="M",
                     help="generate M³ 7-point Poisson matrix")
    src.add_argument("--random", type=int, metavar="N",
                     help="generate random SPD matrix of order N")
    p.add_argument("--nb", type=int, default=256,
                   help="factor block size (default 256)")
    p.add_argument("--solve-group", type=int, default=None,
                   help="solve-megakernel tasks per grid step")
    p.add_argument("--nemin", type=int, default=32,
                   help="amalgamation threshold (default 32)")
    p.add_argument("--ordering", default=None,
                   choices=["amd", "nd-grid", "rcm", "natural"],
                   help="fill-reducing ordering (default: nd-grid for "
                        "generated grids, amd otherwise)")
    p.add_argument("--nrhs", type=int, default=1)
    p.add_argument("--mode", default="batched", choices=["batched", "stf"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--refine", type=int, default=2,
                   help="iterative refinement steps (default 2)")
    p.add_argument("--no-prune-tree", action="store_true")
    p.add_argument("--ndev", type=int, default=1,
                   help="device count for tree partitioning")
    p.add_argument("--reps", type=int, default=1,
                   help="repeat factor+solve (timing)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line with the results")
    p.add_argument("--stats", action="store_true",
                   help="print plan statistics (tree-stat analogue)")
    p.add_argument("--timers", action="store_true",
                   help="print hierarchical step timers")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="dump a Chrome-trace JSON of host-side phases")
    p.add_argument("--schedule", default="scan",
                   choices=["scan", "unrolled", "mega"],
                   help="scan/unrolled = one launch per level and kind; "
                        "mega = the factorization, and each solve sweep, "
                        "as stream kernels (float32 and float64, every nb; "
                        "no fallback)")
    p.add_argument("--coarse", action="store_true",
                   help="batched dense leaf-subtree phase")
    p.add_argument("--dot-tree", metavar="PATH", default=None,
                   help="dump the assembly tree as DOT (atree analogue)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the batched numeric work: cuda "
                        "(default), cuda:N or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import (CscMatrix, Options, analyse, factor, make_rhs,
                   poisson2d, poisson3d, random_spd, solve)
    from .sparse.io import read_matrix

    grid_shape = None
    if args.poisson2d:
        a = poisson2d(args.poisson2d)
        grid_shape = (args.poisson2d,) * 2
        name = f"poisson2d-{args.poisson2d}"
    elif args.poisson3d:
        a = poisson3d(args.poisson3d)
        grid_shape = (args.poisson3d,) * 3
        name = f"poisson3d-{args.poisson3d}"
    elif args.random:
        a = random_spd(args.random)
        name = f"random-{args.random}"
    else:
        path = args.mat or args.mm
        a = read_matrix(path, fmt="mm" if args.mm else None)
        name = path

    ordering = args.ordering or ("nd-grid" if grid_shape else "amd")
    options = Options(
        nb=args.nb, nemin=args.nemin, ordering=ordering,
        grid_shape=grid_shape, mode=args.mode, dtype=args.dtype,
        refine=args.refine, prune_tree=not args.no_prune_tree,
        ndevices=args.ndev, schedule=args.schedule,
        coarse_subtrees=args.coarse, solve_group=args.solve_group,
        device=args.device,
    )
    from .api import _resolve_devices

    try:
        if options.mode == "batched":
            _resolve_devices(options)
    except (RuntimeError, ValueError) as e:
        print(f"spllt_tpu_torch: {e}", file=sys.stderr)
        return 2

    from .utils.timers import print_timers, timer
    from .utils.tracing import TraceLog

    trace = TraceLog() if args.trace else None

    t0 = time.perf_counter()
    with timer("analyse"):
        symb = analyse(a, options)
    t_analyse = time.perf_counter() - t0
    print(f"[analyse] n={symb.n} nnz={a.nnz} nodes={symb.inform.num_nodes} "
          f"nnz(L)={symb.inform.num_factor} "
          f"flops={symb.inform.num_flops:.3e} "
          f"depth={symb.inform.maxdepth} time={t_analyse:.3f}s")
    if args.dot_tree:
        from .utils.dot import atree_dot

        atree_dot(symb, args.dot_tree)
        print(f"[atree  ] wrote {args.dot_tree}")

    xt, b = make_rhs(a, nrhs=args.nrhs)
    t_factor = []
    t_solve = []
    num = None
    x = None
    for rep in range(max(1, args.reps)):
        t0 = time.perf_counter()
        with timer("factor", flops=symb.inform.num_flops):
            if trace:
                with trace.event("factor", rep=rep):
                    num = factor(symb)
            else:
                num = factor(symb)
        t_factor.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        with timer("solve"):
            if trace:
                with trace.event("solve", rep=rep):
                    x = solve(num, b)
            else:
                x = solve(num, b)
        t_solve.append(time.perf_counter() - t0)
    tf = min(t_factor)
    ts = min(t_solve)
    gflops = symb.inform.num_flops / tf / 1e9
    print(f"[factor ] blocks={num.inform.num_blocks} "
          f"levels={num.inform.num_levels} tasks={num.inform.num_tasks} "
          f"time={tf:.4f}s rate={gflops:.1f} GFLOP/s")

    r = a.matvec(x) - b
    bwderr = float(np.linalg.norm(r) / np.linalg.norm(b))
    fwderr = float(np.linalg.norm(x - xt) / np.linalg.norm(xt))
    print(f"[solve  ] nrhs={args.nrhs} time={ts:.4f}s "
          f"bwd_err={bwderr:.3e} fwd_err={fwderr:.3e}")

    if args.stats:
        from .utils.stats import factor_plan_stats, print_stats

        print_stats(factor_plan_stats(num.fplan), out=sys.stdout)
    if args.timers:
        print(print_timers())
    if trace:
        trace.dump(args.trace)
        print(f"[trace  ] wrote {args.trace}")
    if args.json:
        print(json.dumps({
            "matrix": name, "n": symb.n, "nnz": a.nnz,
            "nnz_L": symb.inform.num_factor,
            "flops": symb.inform.num_flops,
            "t_analyse": t_analyse, "t_factor": tf, "t_solve": ts,
            "gflops": gflops, "bwd_err": bwderr, "fwd_err": fwderr,
        }))
    return 0 if bwderr < 1e-4 else 1


if __name__ == "__main__":
    sys.exit(main())
