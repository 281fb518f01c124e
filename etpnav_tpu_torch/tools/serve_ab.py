"""Serving's two device programs timed for two checkouts of the port, in
turns, on the card.

The programs are those of one coalesced serving batch at `r2r_config()`
in the default configuration, with seeded random weights: `perceive` at
B = 8 sessions (96 views) and `score_navigation` at B = 8, G = 64. Each
turn is a fresh process that imports `etpnav_tpu_torch` from its checkout,
so it builds and runs that checkout's kernels. Turns go A B B A (repeated
`--pairs` times) so that a drift of the host's speed falls on both. A turn
reports, per program, the host-clock p50 and min of `--calls`
synchronised calls and the device time of one profiled call (the sum of
its kernels' and copies' device time, from torch.profiler), the copies'
share of it (the pageable upload of the observations varies most between
turns), the part spent in the port's own kernels by group (`KERNEL_GROUPS`: the
K-PRENORM / K-BLOCK chain of csrc/dense.cuh, K-GN, K-ATT, K-NMS) and
their launch counts. `--fused` runs the fused perception configuration
(`use_fused_gn` and `use_fused_block` on) instead.

Usage (from any directory; A and B are checkout roots):
    python3 etpnav_tpu_torch/tools/serve_ab.py A B [--pairs 2] [--calls 30]
        [--fused]
`--device cpu --config tiny` runs it on the CPU at the tiny config (the
plain versions; device_ms is then 0).
Prints one JSON line: every turn, and per checkout the median over its
turns of each number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time


# the port's kernels in a profile, by a piece of their demangled name:
# dense.cuh's kernels live in namespace etp (K-PRENORM's and K-BLOCK's
# chain: LayerNorm, weight rounding, GEMMs, head attention)
KERNEL_GROUPS = {"dense_chain": "etp::", "group_norm": "group_norm",
                 "attention": "attention_fwd", "nms": "nms"}


def _turn(root: str, calls: int, device: str, config: str,
          fused: bool) -> dict:
    """One checkout's numbers, in this process (which must not have
    imported `etpnav_tpu_torch` from elsewhere)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import etpnav_tpu_torch
    from etpnav_tpu_torch import config as config_mod
    from etpnav_tpu_torch.training.agent import Agent, init_agent_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = getattr(config_mod, f"{config}_config")()
    if fused:
        cfg = dataclasses.replace(
            cfg, clip=dataclasses.replace(cfg.clip, use_fused_block=True),
            depth=dataclasses.replace(cfg.depth, use_fused_gn=True))
    agent = Agent(cfg, init_agent_params(cfg, seed=0), device=device)
    on_card = agent.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rng = np.random.default_rng(9)
    B, G, L = 8, 64, cfg.il.max_text_len
    H, Hd = cfg.clip.image_size, cfg.depth.input_size
    D = cfg.planner.hidden_size
    rgb = rng.integers(0, 256, (B, 12, H, H, 3), np.uint8)
    dep = rng.random((B, 12, Hd, Hd, 1), np.float32)
    gmap = {"img_fts": rng.standard_normal((B, G, D)).astype(np.float32),
            "step_ids": rng.integers(0, 20, (B, G)),
            "pos_fts": rng.standard_normal((B, G, 7)).astype(np.float32),
            "mask": np.arange(G)[None].repeat(B, 0) < 40,
            "visited": np.zeros((B, G), bool),
            "pair_dists": rng.random((B, G, G)).astype(np.float32)}
    txt = rng.standard_normal((B, L, D)).astype(np.float32)
    tmask = np.arange(L)[None].repeat(B, 0) < 30
    progs = {"perceive": lambda: agent.perceive(rgb, dep),
             "score_navigation":
                 lambda: agent.score_navigation(txt, tmask, gmap)}
    for fn in progs.values():            # the first calls build the kernels
        fn()
        fn()
    times = {k: [] for k in progs}
    for _ in range(calls):
        for k, fn in progs.items():
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times[k].append((time.perf_counter() - t0) * 1e3)
    res = {"root": root,
           "package": os.path.dirname(etpnav_tpu_torch.__file__)}
    for k, fn in progs.items():
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])) as prof:
            fn()
            sync()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in ev)
        copies_us = sum(e.self_device_time_total for e in ev
                        if e.key.startswith(("Memcpy", "Memset")))
        res[k] = {"p50_ms": statistics.median(times[k]),
                  "min_ms": min(times[k]), "device_ms": dev_us / 1e3,
                  "copies_ms": copies_us / 1e3}
        for group, piece in KERNEL_GROUPS.items():
            mine = [e for e in ev if piece in e.key]
            res[k][f"{group}_ms"] = sum(
                e.self_device_time_total for e in mine) / 1e3
            res[k][f"{group}_launches"] = sum(e.count for e in mine)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="r2r", choices=("r2r", "tiny"))
    ap.add_argument("--fused", action="store_true")
    args = ap.parse_args(argv)
    turns = []
    for root in [args.a, args.b, args.b, args.a] * args.pairs:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", root,
             "--calls", str(args.calls), "--device", args.device,
             "--config", args.config] + (["--fused"] if args.fused else []),
            capture_output=True, text=True, timeout=args.timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"serve_ab: the turn of {root} exited "
                               f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {}
    for root in (args.a, args.b):
        mine = [t for t in turns if t["root"] == root]
        summary[root] = {
            prog: {key: statistics.median(t[prog][key] for t in mine)
                   for key in mine[0][prog]}
            for prog in ("perceive", "score_navigation")}
    return {"turns": turns, "median_over_turns": summary}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--turn":
        turn_ap = argparse.ArgumentParser()
        turn_ap.add_argument("--turn", required=True)
        turn_ap.add_argument("--calls", type=int, required=True)
        turn_ap.add_argument("--device", required=True)
        turn_ap.add_argument("--config", required=True)
        turn_ap.add_argument("--fused", action="store_true")
        t = turn_ap.parse_args()
        print(json.dumps(_turn(t.turn, t.calls, t.device, t.config,
                               t.fused)))
    else:
        print(json.dumps(main()))
