"""Readings of a cell's compared numbers for the program, the control
and the faults, over several seeds in one process: the lower and upper
readings its limits are set from (`navbench/limits/<cell>.json`).

    python3 navbench/control.py --workload <cell> --seeds 1,2,3
        [--seconds 8] [--others fp8,half]

Each seed runs the cell's own path at the cell's size with a short
window (a training cell's numbers come from set-up's first steps), then
the reference, then the control (the reference at the precision below
the configuration's: "fp8") and, for training, the half-batch fault
("half"), each judged against the fp32 reference on the same inputs.
One JSON line per seed. The benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".navbench_cache", sub)
sys.path.insert(0, ROOT)

from navbench import common, harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--others", default="fp8")
    args = ap.parse_args(argv)
    import importlib
    import torch
    _, cell, config, traffic, limits = harness.resolve(ROOT, args.workload)
    driver = importlib.import_module(f"navbench.drivers.{traffic['driver']}")
    others = tuple(o for o in args.others.split(",") if o)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        ctx = common.Context(root=ROOT, cell=cell, config=config,
                             traffic=traffic, limits=limits, seed=seed,
                             seconds=args.seconds, trace=False,
                             t_start=t0)
        out = driver.run(ctx, others=others)
        print(json.dumps({"cell": cell["name"], "seed": seed,
                          "program": out["readings"],
                          **{k: v for k, v in out["others"].items()},
                          "e2e": out["e2e"], "info": out["info"],
                          "setup_s": out["setup_s"],
                          "peak": out["peak"],
                          "s": time.perf_counter() - t0},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
