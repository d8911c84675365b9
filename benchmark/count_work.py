"""Freeze the work of a configuration's matrix into its file.

    python benchmark/count_work.py poisson3d-64 [poisson3d-96 ...]

Runs on the CPU, once per configuration: builds the matrix with the
benchmark's generator, analyses it with the program's ``analyse`` under the
configuration's options on ``device='cpu'``, and writes into the file's
``work`` object n, nnz(A) (lower and full), nnz(L), the factorization's flops,
the pool bytes, the levels and the tasks of the factor plan.  The roofline
metrics read these numbers and never the program's launches, so a later
change to how the program splits its work does not move them.  Nothing that
a benchmark run executes imports this file.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402


def count(config: dict, bench: harness.Bench) -> dict:
    import numpy as np

    import spllt_tpu_torch as st
    from spllt_tpu_torch.plan.blocking import build_block_plan
    from spllt_tpu_torch.plan.factor_tasks import build_factor_plan

    n, colptr, rowind, values = bench.generator(config["generator"])(
        config["matrix"])
    opts = harness.options(config, "cpu")
    symb = st.analyse(st.CscMatrix(n, colptr, rowind, values), opts)
    plan = build_block_plan(symb, opts.nb)
    fplan = build_factor_plan(symb, plan)
    nnz_a = int(colptr[-1])
    diag = int(np.count_nonzero(
        rowind == np.repeat(np.arange(n), np.diff(colptr))))
    esz = 8 if opts.dtype == "float64" else 4
    return dict(
        n=int(n), nnz_a=nnz_a, nnz_a_full=2 * nnz_a - diag,
        nnz_l=int(symb.inform.num_factor), flops=int(symb.inform.num_flops),
        pool_bytes=int((plan.nblocks + 1) * opts.nb * opts.nb * esz),
        levels=int(fplan.nlevels), tasks=int(fplan.num_tasks),
        flop_peak=("tf32" if opts.precision == "default"
                   and opts.dtype == "float32" else "fp32"))


def main(names) -> int:
    bench = harness.Bench()
    for name in names:
        path = bench.config_path(name)
        config = harness.load_json(path)
        config["work"] = count(config, bench)
        with open(path, "w") as f:
            json.dump(config, f, indent=2)
            f.write("\n")
        print(name, json.dumps(config["work"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
