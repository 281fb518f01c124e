"""The benchmark's driver-independent half: finds the cell's files by the
names in BENCHMARK.json, checks for the card, runs the traffic's driver,
reads the per-layer metrics and prints the result line."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys

from navbench import common


def parse(argv):
    ap = argparse.ArgumentParser(prog="navbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def resolve(root: str, name: str) -> tuple:
    """(benchmark, cell, configuration file, traffic file, limits) of the
    cell `name`; limits are {} where the cell has no limits file. Imports
    the reference and FLOP-count modules the configuration file names
    (`common.modules`), so that one that does not import is an error
    here, before any driver runs."""
    bench = _json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(root, conf["file"])
    common.modules(config)
    traffic = _json(root, f"navbench/traffic/{cell['traffic']}.json")
    lim_path = f"navbench/limits/{name}.json"
    limits = (_json(root, lim_path)["numbers"]
              if os.path.exists(os.path.join(root, lim_path)) else {})
    return bench, cell, config, traffic, limits


def applies(metric: dict, cell: dict, e2e_names: set) -> bool:
    """A metric with `workloads` is reported in those cells; a per-layer
    one without, wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def read_metric(root: str, name: str, record: dict):
    path = os.path.join(root, "navbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"navbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def _num(x):
    return x if x is None or math.isfinite(x) else None


def assemble(root: str, bench: dict, cell: dict, out: dict, trace: bool,
             limits: dict) -> tuple:
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    mine = {n for n, m in e2e.items() if "workloads" not in m
            or cell["name"] in m["workloads"]}
    metrics = {}
    if not trace:
        for n in sorted(mine):
            v = out["setup_s"] if n == "setup_s" else out["e2e"][n]
            metrics[n] = {"value": _num(v), "unit": e2e[n]["unit"]}
    else:
        for m in bench["per_layer"]:
            if not applies(m, cell, mine):
                continue
            v = read_metric(root, m["name"], out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = common.judge(out["readings"], limits)
    device = common.device_record(out["peak"], cell["chips"])
    result = {"correct": bool(checks) and all(c["ok"] for c in checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace:
        tw = out["record"]["trace"]
        device["busy_s"] = tw["busy_s"]
        device["window_s"] = tw["window_s"]
        ops = sorted(tw["by_name"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:160], v] for k, v in ops],
                               "idle_gaps": tw["idle_gaps"]}
    result["compared"] = {c["name"]: {"value": _num(c["value"]),
                                      "limit": c["limit"]} for c in checks}
    return result, checks


def main(argv, root: str, t_start: float) -> int:
    args = parse(argv)
    try:
        bench, cell, config, traffic, limits = resolve(root, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"navbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"navbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    driver = importlib.import_module(f"navbench.drivers.{traffic['driver']}")
    ctx = common.Context(root=root, cell=cell, config=config,
                         traffic=traffic, limits=limits, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         t_start=t_start)
    out = driver.run(ctx)
    result, checks = assemble(root, bench, cell, out, ctx.trace, limits)
    print("info " + json.dumps({"cell": cell["name"], "seed": args.seed,
                                "e2e": out["e2e"], **out["info"]},
                               default=str), flush=True)
    bad = common.forbidden_modules()
    if bad:
        print(f"navbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 5
    common.emit(result, checks)
    return 0
