"""What every driver of the benchmark shares: the run's context, the
chip's peaks, percentiles, the device record and the result line."""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence

# NVIDIA H100 SXM data sheet, dense: FLOP/s by precision, HBM bytes/s
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "etpnav_tpu")

# the modules a configuration file may name under these keys, the module
# taken where it names none, and the names the harness calls in them
# (`navbench/compare.py` and `navbench/work/model.py` say how)
MODULES = {"reference": ("navbench.reference.model", ("Ref", "Drop")),
           "work": ("navbench.work.model",
                    ("perceive", "nav", "text", "train_step"))}


def modules(config: dict) -> tuple:
    """(reference, work): the modules the configuration file names under
    `reference` and `work`, navbench's ETPNav ones where it names none.
    Raises ValueError, naming the module, where one does not import or
    lacks a name the harness calls."""
    out = []
    for key, (default, names) in MODULES.items():
        name = config.get(key, default)
        try:
            mod = importlib.import_module(name)
        except ImportError as e:
            raise ValueError(f"the configuration's {key} module {name!r} "
                             f"does not import: {e}") from e
        lacks = [n for n in names if not hasattr(mod, n)]
        if lacks:
            raise ValueError(f"the configuration's {key} module {name!r} "
                             f"lacks {lacks}")
        out.append(mod)
    return tuple(out)


@dataclasses.dataclass
class Context:
    """One run of one cell. `reference` and `work` are the modules the
    configuration file names (`modules`)."""
    root: str                 # the checkout's root
    cell: dict                # the BENCHMARK.json workload entry
    config: dict              # the configuration file
    traffic: dict             # the traffic file
    limits: dict              # navbench/limits/<cell>.json ({} if none)
    seed: int
    seconds: float
    trace: bool
    t_start: float            # perf_counter at process start
    device: str = "cuda"
    reference: Any = dataclasses.field(init=False)
    work: Any = dataclasses.field(init=False)

    def __post_init__(self):
        self.reference, self.work = modules(self.config)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def sub_seed(seed: int, *salt: int) -> int:
    """A 31-bit seed derived from the run's seed and a salt, for APIs
    that take a small integer."""
    import numpy as np
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *salt])
    return int(ss.generate_state(1, dtype=np.uint32)[0] >> 1)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: `etpnav_tpu_torch` is allowed)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_record(peak_bytes: int, count: int = 1) -> dict:
    """The result line's `device` object; `peak_bytes` is read by the
    traffic's driver when the window closes, before the reference runs."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power_limit": power_limit()}


def judge(readings: Dict[str, float], limits: dict) -> List[dict]:
    """Each number the cell's limits name beside its limit: [{name,
    value, limit, ok}]. A number with no reading, or one that is not
    finite, fails."""
    out = []
    for name in limits:
        value = readings.get(name)
        lim = limits[name].get("limit")
        ok = (lim is not None and value is not None
              and math.isfinite(value) and value <= lim)
        out.append({"name": name, "value": value, "limit": lim, "ok": ok})
    return out


def emit(result: dict, checks: List[dict]) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for c in checks:
        print(f"compared {c['name']} = {c['value']!r} "
              f"(limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def copy_out(x):
    """A copy of a tensor or array the program made (or of a dict or list
    of them), so that nothing it later writes into a reused buffer
    reaches what the benchmark keeps."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: copy_out(v) for k, v in x.items()}
    if isinstance(x, list):
        return [copy_out(v) for v in x]
    return x


def tmp_dir() -> str:
    """The run's scratch directory: the caller's TMPDIR."""
    return os.environ.get("TMPDIR") or "/tmp"
