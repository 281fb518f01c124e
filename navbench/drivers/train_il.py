"""IL fine-tuning iterations of `FinetuneTrainer` over the synthetic
world `GeometricNavEnv`.

Each iteration is a schedule-sampled rollout of `envs` episodes, then a
replay learn step at its (T, G) bucket and AdamW. The episodes are a
pool the benchmark makes from the seed: instructions from the
configuration's length list and paths from its published path lengths
(`assumed`), each list in the seed's order; env i's k-th episode is the
(k * envs + i)-th of the pool, so the rows of one batch all differ.

Set-up builds one trainer, drives it through its first `checked_steps`
iterations (each a call of `train(1)`, the window's own call) and keeps
what the reference follows: each step's loss and learn batch, the first
gradient as AdamW holds it (exp_avg / (1 - beta1)) and each leaf's change
after the steps. It then warms the learn buckets the traffic reaches on
zero-valid batches with a generator of its own, so the trainer's state
moves no further. The window runs whole iterations until `--seconds`
have passed: `il_iter_s` is its seconds over the iterations. One of
them, drawn from the seed, is kept (`WindowCheck`) and followed by the
reference from the program's state as it started.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from collections import Counter

import numpy as np
import torch

from navbench import common, compare, probe, program, trace
from navbench.instructions import Cycle, Instructions


def episodes(ctx, cfg) -> list:
    """The traffic's pool of episodes, made from the seed: path lengths
    and hop counts from the configuration's published spread and
    instructions from its length list, each list run through in a new
    order of the seed's every time it is used up (so every two
    iterations of 8 envs hold each of 16 path lengths once), with the
    seed's headings and turns."""
    from etpnav_tpu_torch.env.protocol import Episode
    tr = ctx.traffic["params"]
    rng = np.random.default_rng(common.sub_seed(ctx.seed, 20))
    instr = Instructions(ctx.config["assumed"], cfg.planner.vocab_size, rng)
    spec = ctx.config["assumed"]["path_m"]
    lengths, hops = Cycle(spec["lengths"], rng), Cycle(spec["hops"], rng)
    out = []
    r0, turn = tr["start_radius_m"], tr["turn_rad"]
    for j in range(tr["episodes"]):
        nseg = int(hops.next())
        seg = float(lengths.next()) / nseg
        # start on a circle and head across the world's middle
        a = rng.uniform(0, 2 * math.pi)
        start = np.array([r0 * math.sin(a), 0.0, r0 * math.cos(a)])
        path, heading = [start], a
        for _ in range(nseg):
            heading += rng.uniform(-turn, turn)
            path.append(path[-1] + np.array([-seg * math.sin(heading), 0.0,
                                             -seg * math.cos(heading)]))
        out.append(Episode(
            episode_id=f"nb{j}", scene_id=f"scene{j % 7}",
            instruction_tokens=instr.next(),
            instruction_text=f"benchmark episode {j}",
            start_position=start,
            start_heading=float(rng.uniform(0, 2 * math.pi)),
            goal_position=path[-1], reference_path=[p.copy() for p in path],
            instruction_id=j))
    return out


def make_env(cfg, n: int, eps: list, seed: int):
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv

    class BenchEnv(GeometricNavEnv):
        """Env i's k-th episode is the (k * n + i)-th of the list."""

        def _make_episode(self, env_i: int):
            k = self._episode_counter[env_i]
            self._episode_counter[env_i] += 1
            return eps[(k * n + env_i) % len(eps)]

    return BenchEnv(n, seed=seed, vocab_size=cfg.planner.vocab_size,
                    max_instr_len=cfg.il.max_text_len,
                    image_size=cfg.clip.image_size,
                    depth_size=cfg.depth.input_size,
                    pad_id=cfg.planner.pad_token_id)


def _record_dict(rec) -> dict:
    return {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}


def zero_batch(cfg, B: int, T: int, G: int, L: int, device) -> dict:
    """A learn batch of the bucket's shape with no valid step."""
    from etpnav_tpu_torch.training.finetune import record_to_batch
    from etpnav_tpu_torch.training.rollout import RolloutRecord
    P = cfg.waypoint.max_predictions + 12
    M = T * cfg.waypoint.max_predictions
    p = cfg.planner
    rec = RolloutRecord(
        txt_ids=np.full((B, L), p.pad_token_id, np.int64),
        txt_masks=np.eye(B, L, dtype=bool) | (np.arange(L) == 0),
        vp_rgb=np.zeros((B, T, P, p.image_feat_size), np.float32),
        vp_dep=np.zeros((B, T, P, p.depth_feat_size), np.float32),
        vp_loc=np.zeros((B, T, P, 4), np.float32),
        vp_nav=np.zeros((B, T, P), np.int32),
        vp_mask=np.ones((B, T, P), bool),
        agg_node_step=np.full((B, T, G), -1, np.int32),
        agg_ent_slot=np.zeros((B, T, M), np.int32),
        agg_ent_tok=np.zeros((B, T, M), np.int32),
        agg_ent_val=np.zeros((B, T, M), np.float32),
        gmap_step_ids=np.zeros((B, T, G), np.int32),
        gmap_pos_fts=np.zeros((B, T, G, 7), np.float32),
        gmap_mask=np.ones((B, T, G), bool),
        gmap_visited=np.zeros((B, T, G), bool),
        gmap_pair=np.zeros((B, T, G, G), np.float32),
        teacher=np.full((B, T), -100, np.int32),
        step_valid=np.zeros((B, T), bool),
        logits=np.zeros((B, T, G), np.float32))
    return record_to_batch(rec, device)


class WindowCheck:
    """One iteration of the window kept for the reference: the trained
    leaves as it starts (its rollout and its learn step both read them),
    its rollout's graph tensors and graph embeddings, its learn batch,
    the dropout generator's state as the learn step starts, its loss,
    and each leaf's gradient norm as the optimizer gets it. Kept twice a
    window at most, on its first iteration and on the first to start
    past a point of the window drawn from the seed; the later one is
    compared. Everything is copied as it is kept."""

    def __init__(self, trainer):
        self.trainer, self.on, self.cur, self.kept = trainer, False, None, None
        self.named = [(k, v) for k, v in
                      trainer.train_planner.named_parameters()
                      if v.requires_grad]
        batch_fn = trainer.batch
        score_fn = trainer.agent.score_navigation
        step_fn = trainer.optimizer.step

        def batch(brec):
            if self.on:
                self.cur["batch"] = common.copy_out(_record_dict(brec))
                self.cur["dropout"] = trainer.generator.get_state()
            return batch_fn(brec)

        def score(txt_embeds, txt_masks, gmap):
            out = score_fn(txt_embeds, txt_masks, gmap)
            if self.on:
                self.cur["rollout"].append(common.copy_out(
                    {"gmap": gmap, "embeds": out["gmap_embeds"]}))
            return out

        def step(*a, **kw):
            if self.on:
                have = [(k, v.grad) for k, v in self.named
                        if v.grad is not None]
                self.cur["grad"] = ([f"planner.{k}" for k, _ in have],
                                    torch._foreach_norm([g for _, g in have]))
            return step_fn(*a, **kw)

        trainer.batch = batch
        trainer.agent.score_navigation = score
        trainer.optimizer.step = step

    def iterate(self, keep: bool) -> None:
        """One `train(1)`, kept if `keep`."""
        if keep:
            self.kept = None
            self.cur = {"params": {f"planner.{k}": v.detach().clone()
                                   for k, v in self.named},
                        "rollout": [],
                        "at": len(self.trainer.logs["IL_loss"])}
            self.on = True
        try:
            self.trainer.train(iters=1)
        finally:
            self.on = False
        if keep:
            self.cur["loss"] = self.trainer.logs["IL_loss"][self.cur["at"]]
            self.kept, self.cur = self.cur, None

    def result(self) -> dict:
        """The kept iteration with its numbers on the host (the leaves'
        snapshot stays on the device for the reference)."""
        k = self.kept
        names, norms = k.pop("grad", ([], []))
        k["grad"] = {n: float(v) for n, v in zip(names, norms)}
        for r in k["rollout"]:
            r["gmap"] = {n: compare._np(v) for n, v in r["gmap"].items()}
            r["embeds"] = compare._np(r["embeds"])
        k["batch"] = {n: compare._np(v) for n, v in k["batch"].items()}
        return k


def settle(ctx, cfg, agent, table, device) -> int:
    """The weight seed (`navbench/probe.py`), probed through a NavServer
    over the trainer's own agent, with a few panoramas of the seed."""
    from etpnav_tpu_torch.serving import NavServer
    from navbench.drivers.serve_closed import _pool
    tr = ctx.traffic["params"]
    server = NavServer(cfg, agent=agent, max_batch=tr["envs"],
                       max_wait_ms=0.0)
    try:
        rgb, dep = _pool(cfg, 4, common.sub_seed(ctx.seed, 2), device)
        return probe.settle_weights(ctx, server, table, rgb, dep, device,
                                    tr["probe_steps"])
    finally:
        server.shutdown()


def setup(ctx, device) -> dict:
    from etpnav_tpu_torch.training import finetune
    tr = ctx.traffic["params"]
    cfg = program.load_config(ctx.config)
    params, table = program.agent_params(
        cfg, common.sub_seed(ctx.seed, 1, 0), device)
    n = tr["envs"]
    env = make_env(cfg, n, episodes(ctx, cfg), common.sub_seed(ctx.seed, 21))
    tseed = common.sub_seed(ctx.seed, 22)
    trainer = finetune.FinetuneTrainer(
        cfg, env, params=params, device=device, seed=tseed, tb_dir=None,
        ckpt_dir=common.tmp_dir())
    wseed = settle(ctx, cfg, trainer.agent, table, device)
    planner = trainer.train_planner
    named = dict(planner.named_parameters())
    p0 = {k: v.detach().clone() for k, v in named.items()
          if v.requires_grad}
    batches = []
    batch_fn = trainer.batch

    def keep_batch(brec):
        if len(batches) < tr["checked_steps"]:
            batches.append(common.copy_out(_record_dict(brec)))
        return batch_fn(brec)

    trainer.batch = keep_batch
    # the first rollout's scoring: its graph tensors and embeddings
    rollout = []
    score_fn = trainer.agent.score_navigation

    def keep_score(txt_embeds, txt_masks, gmap):
        out = score_fn(txt_embeds, txt_masks, gmap)
        if not batches:
            rollout.append(common.copy_out(
                {"gmap": gmap, "embeds": out["gmap_embeds"]}))
        return out

    trainer.agent.score_navigation = keep_score
    grad = {}
    for step in range(tr["checked_steps"]):
        trainer.train(iters=1)
        if step == 0:
            # a leaf the optimizer holds no moment of reads 0
            st = trainer.optimizer.state
            grad = {f"planner.{k}": float(st[v]["exp_avg"].norm()) / 0.1
                    if "exp_avg" in st.get(v, {}) else 0.0
                    for k, v in named.items() if v.requires_grad}
    change = {f"planner.{k}": float((named[k].detach() - v).norm())
              for k, v in p0.items()}
    del p0
    trainer.batch = batch_fn
    trainer.agent.score_navigation = score_fn
    for r in rollout:
        r["embeds"] = r["embeds"].float().cpu().numpy()
    # the learn buckets the traffic reaches warmed, on a generator of
    # their own
    il = cfg.il
    g = torch.Generator(device=device).manual_seed(tseed + 7)
    for T, G in tr["warm_buckets"]:
        b = zero_batch(cfg, n, T, G, il.max_text_len, device)
        loss = finetune.compute_il_loss(planner, cfg, b, g)
        loss.backward()
        trainer.optimizer.zero_grad(set_to_none=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    checked = {"loss": list(trainer.logs["IL_loss"][:tr["checked_steps"]]),
               "grad": grad, "change": change,
               "rollout": rollout}
    check = WindowCheck(trainer)
    return {"cfg": cfg, "table": table, "trainer": trainer,
            "batches": batches, "checked": checked, "wseed": wseed,
            "dseed": tseed + 1, "m": ctx.config["model"], "n": n,
            "check": check}


def window(ctx, st: dict, spans=None, attn=None) -> dict:
    trainer = st["trainer"]
    logs = trainer.logs
    start = len(logs["IL_loss"])
    m, cfg, n = st["m"], st["cfg"], st["n"]
    wk = Counter()
    buckets = []
    dw = None
    check = st["check"]
    # the window's kept iteration starts past this share of it
    mark = np.random.default_rng(common.sub_seed(ctx.seed, 23)).uniform(
        0.25, 0.75) * ctx.seconds
    marked = False
    t0 = time.perf_counter()
    it = 0
    while True:
        traced = ctx.trace and it == ctx.traffic["params"]["trace_iter"]
        keep = it == 0 or (not marked
                           and time.perf_counter() - t0 >= mark)
        marked = marked or (it > 0 and keep)
        if traced:
            with trace.DeviceWindow() as dw:
                attn.active = True
                check.iterate(keep)
                attn.active = False
        else:
            check.iterate(keep)
        it += 1
        T, G = trainer.last_bucket
        buckets.append((T, G))
        wk += ctx.work.train_step(m, n, T, G, cfg.il.max_text_len)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    t_end = time.perf_counter()
    summary = None
    if dw is not None:
        summary = dw.summary(spans, ("learn", "perceive", "score",
                                     "encode_text", "rollout"))
    return {"t0": t0, "t_end": t_end, "iters": it, "trace": summary,
            "rollout_s": logs["rollout_s"][start:],
            "learn_s": logs["learn_s"][start:], "buckets": buckets,
            "work": wk}


def rollout_work(work, m: dict, steps: int, envs: int, L: int,
                 G: int) -> Counter:
    """A rollout's forward passes by the FLOP-count module `work`:
    perceive and scoring (at the record's G) for every live step, the
    text once per episode."""
    return (work.perceive(m, steps) + work.nav(m, steps, G, L)
            + work.text(m, envs, L))


def run(ctx, others=()) -> dict:
    """One run of the cell; `others` adds readings of the control
    (\"fp8\") and of a fault (\"half\": half of each batch left out) on
    the same recorded batches."""
    from etpnav_tpu_torch.training import finetune
    device = torch.device(ctx.device)
    st = setup(ctx, device)
    spans = attn = None
    trainer = st["trainer"]
    if ctx.trace:
        spans = trace.Spans()
        agent = trainer.agent
        spans.wrap(agent, "perceive", "perceive")
        spans.wrap(agent, "score_navigation", "score")
        spans.wrap(agent, "encode_text", "encode_text")
        spans.wrap(finetune, "learn_step", "learn")
        attn = trace.AttentionCount()
    # the rollout's live steps, counted for the work of the window
    steps = []
    run_fn = trainer.engine.run

    def counted_run(*a, **kw):
        rec = run_fn(*a, **kw)
        steps.append(int(rec.step_valid.sum()))
        return rec

    trainer.engine.run = counted_run
    if spans is not None:
        spans.wrap(trainer.engine, "run", "rollout")
    setup_s = time.perf_counter() - ctx.t_start
    try:
        w = window(ctx, st, spans, attn)
    finally:
        if attn is not None:
            attn.restore()
        if spans is not None:
            spans.restore()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    secs = w["t_end"] - w["t0"]
    cfg, m = st["cfg"], st["m"]
    wk = w["work"]
    for s in steps:
        wk += rollout_work(ctx.work, m, s, st["n"], cfg.il.max_text_len,
                           cfg.planner.max_gmap_len)
    out = {"attempted": w["iters"], "failed": 0, "peak": peak,
           "setup_s": setup_s,
           "e2e": {"il_iter_s": secs / w["iters"]},
           "info": {"iters": w["iters"],
                    "buckets": dict(Counter(map(str, w["buckets"]))),
                    "loss_first": st["checked"]["loss"]}}
    if ctx.trace:
        out["record"] = {"window_s": secs, "trace": w["trace"],
                         "spans": spans.spans, "t0": w["t0"],
                         "t_end": w["t_end"], "work": dict(wk),
                         "rollout_s": w["rollout_s"],
                         "learn_s": w["learn_s"],
                         "attention_bound_s": attn.bound_s,
                         "attention_calls": attn.calls}
    trainer.close()
    batches, checked = st["batches"], st["checked"]
    checked["window"] = st["check"].result()
    out["info"]["window_iter"] = checked["window"]["at"]
    table, wseed, dseed = st["table"], st["wseed"], st["dseed"]
    del st, trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = compare.train_reference(ctx.reference, batches,
                                   checked["rollout"], table, m, wseed,
                                   dseed, device, window=checked["window"])
    out["readings"] = compare.train_readings(checked, want)
    out["others"] = {}
    for mode in others:
        side = compare.train_reference(
            ctx.reference, batches, checked["rollout"], table, m, wseed,
            dseed, device, mode="fp8" if mode == "fp8" else "fp32",
            half=mode == "half", window=checked["window"])
        side["rollout"] = [dict(r, embeds=e) for r, e in zip(
            checked["rollout"], side["rollout_embeds"])]
        sw = side["window"]
        sw["rollout"] = [dict(r, embeds=e) for r, e in zip(
            checked["window"]["rollout"], sw["rollout_embeds"])]
        out["others"][mode] = compare.train_readings(side, want)
    out["info"]["loss_ref"] = want["loss"]
    out["info"]["window_readings"] = compare.window_readings(
        checked["window"], want["window"])
    print(f"train: {w['iters']} iterations in the window", file=sys.stderr)
    return out
