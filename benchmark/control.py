"""Read the number that decides ``correct`` over several seeds in one
process: for the program as its configuration states it, or, with
``--control``, for the configuration's control (its ``control`` options: the
precision below the one it states), which has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 5 [--control]

Prints one JSON line a seed: the seed, ``correct``, the steps run and each
number compared with its limit.  The benchmark's own runs never run this;
it is how the limits in the configurations' ``correct`` were set.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    from benchmark import harness

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    bench = harness.Bench()
    w = bench.workload(args.workload)
    overrides = bench.config(w["config"])["control"] if args.control else None
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, time.perf_counter(),
                               overrides=overrides)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": overrides, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
