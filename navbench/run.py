"""Runs one cell of the benchmark once and prints its result line.

    python3 navbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json; it names its
configuration (`navbench/configs/<name>.json`) and its traffic
(`navbench/traffic/<name>.json`), whose `driver` is a module of
`navbench/drivers/`. With `--trace 1` the result carries the cell's
per-layer metrics, each read by `navbench/metrics/<metric>.py`.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every build and kernel cache of the run inside the checkout, at fixed
# paths; libraries that could load JAX by themselves are kept from it
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".navbench_cache", sub)
os.environ["USE_FLAX"] = "0"

sys.path.insert(0, ROOT)

from navbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], ROOT, T_START))
