"""Closed-loop sessions against `NavServer`.

`clients` threads each run one session after another: create it with an
instruction from the configuration's length list, step it with
panoramas from a pool made at set-up from the seed (12 views, RGB uint8
and depth in [0, 1]), move to the returned ghost, and on `done` (a stop,
or the force stop) close it and start the next at once. A client sends
its next step only when the last one has come back.

The window counts the steps completed in it: `nav_steps_per_s` is their
number over the window's seconds, `step_p95_ms` the 95th percentile of
their client-side latency. The traced run adds synchronised spans around
the agent's programs and the batcher's `_process`, and profiles a
stretch of the window.
"""

from __future__ import annotations

import gc
import math
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

from navbench import common, compare, probe, program, trace
from navbench.instructions import Cycle, Instructions


def _keep(cur: dict) -> dict:
    """A kept batch: the program's outputs and session state copied, the
    observations left as the views of the read-only pool they are."""
    return {k: v if k in ("rgb", "depth") else common.copy_out(v)
            for k, v in cur.items()}


class Recorder:
    """Keeps what the timed path produced for a sample of its batches and
    the batch with the largest graph: the rows' sessions, instructions
    and observations, the agent's outputs, the graph tensors and the
    logits. The sample is a reservoir of `max_keep` batches, drawn from
    the seed, uniform over the window whatever its rate. Each kept
    batch's program outputs are copied when it is kept, right after its
    `_process` returns; its observations are the clients' own pool
    arrays, which are read-only. Counts the window's model work by the
    FLOP-count module `work`."""

    def __init__(self, server, m: dict, work, rng, max_keep: int):
        self.m = m
        self.rng, self.max_keep = rng, max_keep
        self.active = False
        self.kept, self.longest = [], None
        self.work = Counter()
        self.batches = 0
        self.cur = None
        agent = server.agent
        proc, perc, score = server._process, agent.perceive, \
            agent.score_navigation

        def _process(batch):
            cur = {"n": len(batch),
                   "sids": [p.session.sid for p in batch],
                   "rgb": [p.rgb for p in batch],
                   "depth": [p.depth for p in batch],
                   "txt": [p.session.txt_embeds for p in batch],
                   "txt_mask": [p.session.txt_mask for p in batch]}
            self.cur = cur
            active = self.active
            proc(batch)
            self.cur = None
            if not active:
                return
            self.batches += 1
            self.work += work.perceive(m, cur["n"])
            self.work += work.nav(m, cur["n"], cur["G"],
                                  len(cur["txt_mask"][0]))
            if len(self.kept) < self.max_keep:
                self.kept.append(_keep(cur))
            else:
                j = int(self.rng.integers(self.batches))
                if j < self.max_keep:
                    self.kept[j] = _keep(cur)
            if self.longest is None or cur["G"] > self.longest["G"]:
                self.longest = _keep(cur)

        def perceive(rgb, depth, generator=None):
            out = perc(rgb, depth, generator)
            if self.cur is not None:
                self.cur["wp"] = {
                    k: out[k] for k in ("heatmap", "cand_valid",
                                        "cand_angles", "cand_distances",
                                        "pano_embeds", "pano_masks")}
            return out

        def score_navigation(txt_embeds, txt_masks, gmap):
            out = score(txt_embeds, txt_masks, gmap)
            if self.cur is not None:
                self.cur.update(gmap=gmap, G=gmap["img_fts"].shape[1],
                                logits=out["global_logits"],
                                gmap_embeds=out["gmap_embeds"])
            return out

        server._process = _process
        agent.perceive = perceive
        agent.score_navigation = score_navigation

    def records(self) -> list:
        out = list(self.kept)
        if self.longest is not None and all(
                r["G"] < self.longest["G"] for r in out):
            out.append(self.longest)
        return out


def drive(server, sid: int, rgb, dep, rng, steps: int, out: list,
          stop=None) -> int:
    """Step session `sid` up to `steps` times (fewer if the server says
    done or `stop` is set), each with a pool panorama drawn by `rng`,
    moving to the returned ghost; appends (sent, returned) perf_counter
    pairs to `out`. Returns the steps taken."""
    pos = np.array([rng.uniform(-3, 3), 0.0, rng.uniform(-3, 3)])
    heading = rng.uniform(0, 2 * math.pi)
    for k in range(steps):
        if stop is not None and stop.is_set():
            return k
        i = int(rng.integers(len(rgb)))
        t0 = time.perf_counter()
        res = server.step(sid, rgb[i], dep[i], pos, _quat(heading))
        out.append((t0, time.perf_counter()))
        if res["done"]:
            return k + 1
        act = res["action"]
        if act["act"] == 4:
            goal = np.asarray(act["ghost_pos"], np.float64)
            d = goal - pos
            heading = math.atan2(-d[0], -d[2]) % (2 * math.pi)
            pos = goal
    return steps


def _quat(heading: float) -> np.ndarray:
    return np.array([0.0, math.sin(heading / 2), 0.0, math.cos(heading / 2)])


def _pool(cfg, n: int, seed: int, device) -> tuple:
    """n panoramas made on the device from the seed: RGB uint8
    (n, 12, S, S, 3) and depth in [0, 1] (n, 12, Sd, Sd, 1), on the
    host."""
    g = torch.Generator(device=device).manual_seed(seed)
    S, Sd = cfg.clip.image_size, cfg.depth.input_size
    rgb = torch.randint(0, 256, (n, 12, S, S, 3), generator=g,
                        device=device, dtype=torch.uint8)
    dep = torch.rand(n, 12, Sd, Sd, 1, generator=g, device=device)
    rgb, dep = rgb.cpu().numpy(), dep.cpu().numpy()
    rgb.setflags(write=False)
    dep.setflags(write=False)
    return rgb, dep


def setup(ctx, device) -> dict:
    """The server with the seed's weights, warmed on every program and
    bucket the traffic uses, the panorama pool and the clients."""
    from etpnav_tpu_torch.serving import NavServer
    from etpnav_tpu_torch.training.agent import Agent
    tr = ctx.traffic["params"]
    cfg = program.load_config(ctx.config)
    params, table = program.agent_params(
        cfg, common.sub_seed(ctx.seed, 1, 0), device)
    agent = Agent(cfg, params, device=device)
    server = NavServer(cfg, agent=agent, max_batch=tr["max_batch"],
                       max_wait_ms=tr["max_wait_ms"])
    server.warmup()
    rgb, dep = _pool(cfg, tr["pool"], common.sub_seed(ctx.seed, 2), device)
    wseed = probe.settle_weights(ctx, server, table, rgb, dep, device,
                                 max(tr["episode_steps"]))
    m = ctx.config["model"]
    rec = Recorder(server, m, ctx.work,
                   np.random.default_rng(common.sub_seed(ctx.seed, 3)),
                   tr["keep_batches"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"cfg": cfg, "table": table, "server": server, "rgb": rgb,
            "dep": dep, "rec": rec, "m": m, "tokens": {},
            "device": device, "wseed": wseed}


def window(ctx, st: dict, spans=None, attn=None) -> dict:
    """Run the clients over the window; returns the steps completed in
    it with their latencies, failures, and the trace summary."""
    tr = ctx.traffic["params"]
    server, rgb, dep = st["server"], st["rgb"], st["dep"]
    cfg = st["cfg"]
    stop = threading.Event()
    go = threading.Event()
    done_steps = [[] for _ in range(tr["clients"])]
    failures = []
    sessions = [0] * tr["clients"]
    early = [0] * tr["clients"]
    lock = threading.Lock()

    def client(ci: int):
        rng = np.random.default_rng(common.sub_seed(ctx.seed, 10, ci))
        instr = Instructions(ctx.config["assumed"], cfg.planner.vocab_size,
                             rng)
        plan = Cycle(tr["episode_steps"], rng)
        go.wait()
        while not stop.is_set():
            toks = instr.next()
            sid = server.create_session(toks)
            with lock:
                st["tokens"][sid] = toks
            sessions[ci] += 1
            want = plan.next()
            try:
                took = drive(server, sid, rgb, dep, rng, want,
                             done_steps[ci], stop)
                if took < want and not stop.is_set():
                    early[ci] += 1
            except Exception as e:          # a failed step is counted
                failures.append((time.perf_counter(), repr(e)))
            try:
                server.close_session(sid)
            except (KeyError, RuntimeError) as e:
                failures.append((time.perf_counter(), repr(e)))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(tr["clients"])]
    for t in threads:
        t.start()
    rec = st["rec"]
    stats0 = server.stats()
    t0 = time.perf_counter()
    rec.active = True
    go.set()
    dw = None
    if ctx.trace:
        time.sleep(min(tr["trace_offset_s"], ctx.seconds / 3))
        with trace.DeviceWindow() as dw:
            attn.active = True
            time.sleep(tr["trace_seconds"])
            attn.active = False
    left = t0 + ctx.seconds - time.perf_counter()
    if left > 0:
        time.sleep(left)
    t_end = time.perf_counter()
    rec.active = False
    stats1 = server.stats()
    stop.set()
    for t in threads:
        t.join(timeout=120)
    alive = sum(t.is_alive() for t in threads)
    server.shutdown()
    summary = None
    if dw is not None:
        summary = dw.summary(spans, ("perceive", "score", "encode_text",
                                     "process"))
    lat = [b - a for c in done_steps for a, b in c if b <= t_end]
    fails = [f for f in failures if f[0] <= t_end]
    return {"t0": t0, "t_end": t_end, "lat": lat, "failed": len(fails),
            "failures": failures[:5], "alive": alive, "trace": summary,
            "sessions": sum(sessions), "early_stops": sum(early),
            "stats": (stats0, stats1)}


def run(ctx, others=()) -> dict:
    """One run of the cell; `others` (\"fp8\") adds the control's readings
    on the same kept batches."""
    device = torch.device(ctx.device)
    st = setup(ctx, device)
    spans = attn = None
    if ctx.trace:
        spans = trace.Spans()
        agent = st["server"].agent
        spans.wrap(agent, "perceive", "perceive")
        spans.wrap(agent, "score_navigation", "score")
        spans.wrap(agent, "encode_text", "encode_text")
        spans.wrap(st["server"], "_process", "process")
        attn = trace.AttentionCount()
    setup_s = time.perf_counter() - ctx.t_start
    try:
        w = window(ctx, st, spans, attn)
    finally:
        if attn is not None:
            attn.restore()
    if w["alive"]:
        raise RuntimeError(f"{w['alive']} clients did not stop")
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    rec = st["rec"]
    n = len(w["lat"])
    secs = w["t_end"] - w["t0"]
    out = {"attempted": n + w["failed"], "failed": w["failed"],
           "peak": peak, "setup_s": setup_s,
           "e2e": {"nav_steps_per_s": n / secs,
                   "step_p95_ms": (common.percentile(w["lat"], 95) * 1e3
                                   if n else float("inf"))},
           "info": {"steps": n, "sessions": w["sessions"],
                    "early_stops": w["early_stops"], "weight_seed": st[
                        "wseed"],
                    "occupancy": occupancy(w["stats"], ctx.traffic[
                        "params"]["max_batch"]),
                    "step_p50_ms": (common.percentile(w["lat"], 50) * 1e3
                                    if n else None),
                    "batches": rec.batches, "kept": len(rec.records()),
                    "failures": w["failures"]}}
    if ctx.trace:
        tw = w["trace"]
        out["record"] = {
            "window_s": secs, "trace": tw, "spans": spans.spans,
            "t0": w["t0"], "t_end": w["t_end"],
            "stats": w["stats"], "max_batch": ctx.traffic["params"][
                "max_batch"],
            "work": dict(rec.work + ctx.work.text(
                st["m"], w["sessions"], st["cfg"].il.max_text_len)),
            "batches": rec.batches,
            "steps": n, "attention_bound_s": attn.bound_s,
            "attention_calls": attn.calls, "order": (
                "perceive", "score", "encode_text", "process")}
    records = compare.host_records(rec.records())
    tokens, table, m = dict(st["tokens"]), st["table"], st["m"]
    wseed = st["wseed"]
    cfg = st["cfg"]
    del st, rec, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    args = (ctx.reference, records, tokens, table, m, wseed, device,
            cfg.il.max_text_len, cfg.planner.pad_token_id)
    out["readings"] = compare.serve_readings(*args)
    out["others"] = {mode: compare.serve_readings(*args, other=mode)
                     for mode in others}
    print(f"serve: {n} steps, {len(records)} batches compared",
          file=sys.stderr)
    return out


def occupancy(stats, max_batch: int):
    """Steps served over the slots of the window's batches."""
    s0, s1 = stats
    b = s1["batches"] - s0["batches"]
    return (s1["steps_served"] - s0["steps_served"]) / (b * max_batch) \
        if b else None
