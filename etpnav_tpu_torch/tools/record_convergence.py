"""Record a `learning_demo` run of the port into its CONVERGENCE.json
(the port's counterpart of `tools/record_convergence.py`).

Usage: python -m etpnav_tpu_torch.tools.record_convergence RUN_OUTPUT
       [--note TEXT] [--out PATH]

Parses the demo's one-JSON-line-per-eval output and writes
{"curve": [...], "summary": {...}} to `etpnav_tpu_torch/CONVERGENCE.json`
(or --out). The root CONVERGENCE.json is the JAX package's record and is
never written here. The summary keeps what a reader needs to judge the
run without the full curve: final and best SR / SPL, the iteration
count, the final IL loss and seconds per iteration. The last line of
standard output is the summary.
"""

from __future__ import annotations

import argparse
import json
import os

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "CONVERGENCE.json")


def parse_curve(path: str) -> list:
    """The eval points of a demo log (lines that are JSON objects with an
    "iter" and a "success"), one per iteration (the last line of an
    iteration wins: appended session logs may repeat one), by iteration."""
    by_iter = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "iter" in d and "success" in d:
                by_iter[d["iter"]] = d
    return [by_iter[i] for i in sorted(by_iter)]


def summarize(curve: list, note: str = "") -> dict:
    best = max(curve, key=lambda d: d.get("success", 0.0))
    last = curve[-1]
    out = {
        "iters": last["iter"],
        "sr_final": last.get("success"),
        "spl_final": last.get("spl"),
        "sr_best": best.get("success"),
        "spl_best": best.get("spl"),
        "best_iter": best["iter"],
        "il_loss_final": last.get("IL_loss"),
        "sec_per_iter": last.get("sec_per_iter"),
        "sr_curve": {str(d["iter"]): d.get("success") for d in curve},
    }
    if note:
        out["note"] = note
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_output")
    ap.add_argument("--note", default="")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    curve = parse_curve(args.run_output)
    if not curve:
        raise SystemExit(f"no eval lines found in {args.run_output}")
    summary = summarize(curve, args.note)
    with open(args.out, "w") as f:
        json.dump({"curve": curve, "summary": summary}, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
