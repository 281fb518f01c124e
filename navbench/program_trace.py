"""Runs one cell with the port's tracer on and reads the program's own
spans (`etpnav_tpu_torch/utils/logging.py`).

    python3 navbench/program_trace.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1> --tracer <0|1> [--spans-out FILE]

It runs the cell as `navbench/run.py` does and prints its lines. With
`--tracer 1` the tracer is turned on as the cell's window starts, after
set-up, and its spans are exported once the window has closed; the run
then prints one more line, `program {...}`: with `--trace 1` the numbers
below, with `--trace 0` only the count of spans (what tracing costs is
read from the result line's end-to-end metrics); `--spans-out` writes
the exported spans, the window's bounds and the device's idle intervals
to FILE as JSON. With `--tracer 0` it is the cell's own run.

From the spans of the window:
- serving: `queue_wait_ms` (mean `serve.queue_wait` of its requests, and
  the p95), `collect_ms` (mean `serve.collect` a batch), `text_ms` (mean
  `serve.encode_text` a session), `upload_ms` (device ms of the
  batcher's `agent.upload` spans a `serve.batch`), the mean host ms of
  `serve.batch` and of each of its stages, and how much of each batch its
  five stages cover;
- training: per iteration, the summed ms of each `rollout.*` span; the
  mean device ms of `learn.forward`, `learn.backward`,
  `learn.optimizer` and the host ms of each learn span; how much of
  `train.rollout` the `rollout.*` spans cover and of `train.learn` the
  learn spans' host intervals.

From the traced stretch (`navbench/trace.py`'s profiler window), every
interval in which the device ran nothing, mapped onto the host clock and
split by overlap over the innermost span open on the batcher's thread
(serving) or the trainer's (training): `idle_by_span` in seconds, with
`untraced` for idle time no span of that thread covers, and the shares
of the stretch `idle_map` (idle while the batcher is in `serve.map`) and
`idle_env` (idle while the trainer is in `rollout.env`), in %.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVE_STAGES = ("serve.stage", "serve.perceive", "serve.map", "serve.score",
                "serve.translate")
ROLLOUT = ("rollout.env", "rollout.text", "rollout.record",
           "rollout.perceive", "rollout.map", "rollout.score",
           "rollout.teacher")
LEARN = ("learn.forward", "learn.backward", "learn.optimizer")


# ---------------------------------------------------------------- arithmetic

def named(spans: list, name: str, t0: float = -1e300,
          t1: float = 1e300) -> list:
    """The `name` spans that started in [t0, t1)."""
    return [s for s in spans if s["name"] == name and t0 <= s["t0"] < t1]


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def dur_ms(s: dict) -> float:
    return 1e3 * (s["t1"] - s["t0"])


def depth(s: dict, by_id: dict) -> int:
    d = 0
    while s["parent"] is not None and s["parent"] in by_id:
        s, d = by_id[s["parent"]], d + 1
    return d


def innermost(spans: list) -> list:
    """The spans of one thread, nested, flattened into disjoint
    [(start, end, name)]: at each moment the innermost open span."""
    by_id = {s["id"]: s for s in spans}
    ev = []
    for s in spans:
        d = depth(s, by_id)
        ev.append((s["t0"], 1, d, s))
        ev.append((s["t1"], 0, -d, s))
    ev.sort(key=lambda e: e[:3])
    out, stack, last = [], [], None
    for t, opens, _, s in ev:
        if stack and t > last:
            out.append((last, t, stack[-1]["name"]))
        if opens:
            stack.append(s)
        else:
            stack.remove(s)
        last = t
    return out


def split_idle(gaps: list, segments: list) -> dict:
    """Seconds of the idle intervals `gaps` [(start, end)] by the name of
    the segment [(start, end, name)] they overlap; `untraced` for the
    rest."""
    out = collections.Counter()
    segments = sorted(segments)
    j = 0
    for a, b in sorted(gaps):
        # segments are disjoint and sorted: skip those ending before a
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(segments) and segments[k][0] < b:
            s, e, name = segments[k]
            o = min(b, e) - max(a, s)
            if o > 0:
                out[name] += o
                covered += o
            k += 1
        if b - a - covered > 0:
            out["untraced"] += b - a - covered
    return dict(out)


def idle_intervals(events: list, offset: float, h0: float,
                   h1: float) -> list:
    """The stretch [h0, h1]'s (host clock) intervals with no device
    activity, from device intervals [(start, end)] in profiler seconds
    (host = device - offset)."""
    iv = sorted((a - offset, b - offset) for a, b in events)
    gaps, cur = [], h0
    for a, b in iv:
        if a > cur:
            gaps.append((cur, min(a, h1)))
        cur = max(cur, b)
        if cur >= h1:
            break
    if cur < h1:
        gaps.append((cur, h1))
    return [(a, b) for a, b in gaps if b > a]


def coverage(spans: list, parents: list, kids: tuple) -> list:
    """For each parent span, the share of its host interval its direct
    children named in `kids` cover."""
    out = []
    for p in parents:
        c = sum(s["t1"] - s["t0"] for s in spans
                if s["parent"] == p["id"] and s["name"] in kids)
        out.append(c / max(p["t1"] - p["t0"], 1e-12))
    return out


def _idle(spans, thread, idle, window_s, stage) -> dict:
    if idle is None or thread is None:
        return {}
    mine = [s for s in spans if s["thread"] == thread]
    by = split_idle(idle, innermost(mine))
    return {"idle_by_span": by,
            f"idle_{stage.split('.')[1]}": 100.0 * by.get(stage, 0.0)
            / window_s}


def serve_numbers(spans: list, t0: float, t1: float, idle=None,
                  window_s: float = 0.0) -> dict:
    from navbench import common
    batches = named(spans, "serve.batch", t0, t1)
    waits = [dur_ms(s) for s in named(spans, "serve.queue_wait", t0, t1)]
    bids = {b["key"] for b in batches}
    thread = batches[0]["thread"] if batches else None
    ups = [s["device_ms"] for s in named(spans, "agent.upload", t0, t1)
           if s["thread"] == thread and s["key"] in bids
           and s["device_ms"] is not None]
    cov = coverage(spans, batches, SERVE_STAGES)
    out = {"batches": len(batches), "requests": len(waits),
           "queue_wait_ms": mean(waits),
           "queue_wait_p95_ms": (common.percentile(waits, 95)
                                 if waits else None),
           "collect_ms": mean(dur_ms(s) for s in
                              named(spans, "serve.collect", t0, t1)),
           "text_ms": mean(dur_ms(s) for s in
                           named(spans, "serve.encode_text", t0, t1)),
           "upload_ms": sum(ups) / len(batches) if ups else None,
           "batch_ms": mean(dur_ms(b) for b in batches),
           "stage_ms": {n: mean(dur_ms(s) for s in named(spans, n, t0, t1))
                        for n in SERVE_STAGES},
           "stage_cover_min": min(cov) if cov else None,
           "stage_cover_mean": mean(cov)}
    out.update(_idle(spans, thread, idle, window_s, "serve.map"))
    return out


def train_numbers(spans: list, t0: float, t1: float, idle=None,
                  window_s: float = 0.0) -> dict:
    rolls = named(spans, "train.rollout", t0, t1)
    learns = named(spans, "train.learn", t0, t1)
    its = {r["key"] for r in rolls}
    per_iter = {}
    for n in ROLLOUT:
        ss = [s for s in spans if s["name"] == n and s["key"][0] in its]
        per_iter[n] = sum(dur_ms(s) for s in ss) / len(its) if its else None
    dev = {n: mean(s["device_ms"] for s in named(spans, n, t0, t1)
                   if s["device_ms"] is not None) for n in LEARN}
    host = {n: mean(dur_ms(s) for s in named(spans, n, t0, t1))
            for n in ("learn.batch",) + LEARN}
    rc = coverage(spans, rolls, ROLLOUT)
    lc = coverage(spans, learns, ("learn.batch",) + LEARN)
    thread = rolls[0]["thread"] if rolls else None
    out = {"iterations": len(rolls), "rollout_ms_per_iter": per_iter,
           "env_ms": per_iter["rollout.env"],
           "perceive_ms": per_iter["rollout.perceive"],
           "map_ms": per_iter["rollout.map"],
           "score_ms": per_iter["rollout.score"],
           "teacher_ms": per_iter["rollout.teacher"],
           "fwd_ms": dev["learn.forward"], "bwd_ms": dev["learn.backward"],
           "adamw_ms": dev["learn.optimizer"], "learn_host_ms": host,
           "rollout_ms": mean(dur_ms(r) for r in rolls),
           "learn_ms": mean(dur_ms(s) for s in learns),
           "rollout_cover_min": min(rc) if rc else None,
           "learn_cover_min": min(lc) if lc else None,
           "learn_cover_mean": mean(lc)}
    out.update(_idle(spans, thread, idle, window_s, "rollout.env"))
    return out


# ---------------------------------------------------------------- the run

def _device_idle(dw) -> list:
    """`idle_intervals` of a closed `trace.DeviceWindow`, or None where its
    spin mark is missing."""
    import torch
    ev = [e for e in dw.prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.time_range.end > e.time_range.start]
    mark = [e for e in ev if "sleep" in e.name or "spin" in e.name]
    if not mark:
        return None
    offset = mark[0].time_range.start / 1e6 - dw.t_mark
    iv = [(e.time_range.start / 1e6, e.time_range.end / 1e6)
          for e in ev if e is not mark[0]]
    return idle_intervals(iv, offset, dw.h0, dw.h1)


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="navbench/program_trace.py",
                                 allow_abbrev=False)
    ap.add_argument("--tracer", type=int, choices=(0, 1), required=True)
    ap.add_argument("--spans-out")
    args, rest = ap.parse_known_args(argv)
    from navbench import harness, trace
    cell_args = harness.parse(rest)
    _, cell, _, traffic, _ = harness.resolve(ROOT, cell_args.workload)
    if not args.tracer:
        return harness.main(rest, ROOT, t_start)
    from etpnav_tpu_torch.utils import logging as tracing
    if not hasattr(tracing, "export"):
        print("program_trace: this port has no tracer", file=sys.stderr)
        return 4
    import importlib
    runner = importlib.import_module(f"navbench.drivers.{traffic['driver']}")
    got = {}
    window, summary = runner.window, trace.DeviceWindow.summary

    def traced_window(ctx, st, *a, **kw):
        tracing.enable()
        try:
            got["w"] = window(ctx, st, *a, **kw)
        finally:
            tracing.disable()
        got["export"] = tracing.export()
        return got["w"]

    def kept_summary(self, *a, **kw):
        got["idle"] = _device_idle(self)
        return summary(self, *a, **kw)

    runner.window = traced_window
    trace.DeviceWindow.summary = kept_summary
    rc = harness.main(rest, ROOT, t_start)
    if rc or "export" not in got:
        return rc or 4
    spans, w = got["export"]["spans"], got["w"]
    if args.spans_out:
        with open(args.spans_out, "w") as f:
            json.dump({"spans": spans, "t0": w["t0"], "t_end": w["t_end"],
                       "idle": got.get("idle"), "trace": w.get("trace")},
                      f, default=str)
    line = {"cell": cell["name"], "seed": cell_args.seed,
            "spans": len(spans), "dropped": got["export"]["dropped"]}
    if cell_args.trace:
        idle = got.get("idle")
        tw = w["trace"]
        fn = serve_numbers if traffic["driver"] == "serve_closed" \
            else train_numbers
        line.update(fn(spans, w["t0"], w["t_end"], idle, tw["window_s"]))
        line["traced_idle_s"] = (sum(b - a for a, b in idle)
                                 if idle is not None else None)
        line["traced_window_s"] = tw["window_s"]
    print("program " + json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    T_START = time.perf_counter()
    # as navbench/run.py: the run's caches inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, ".navbench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:], T_START))
