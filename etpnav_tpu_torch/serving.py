"""Online serving: session-based navigation inference with dynamic
batching onto fixed device batch slots (counterpart of
`etpnav_tpu/serving.py`, with the same session API).

- `NavSession`  - host-side per-episode state: the encoded instruction,
  the topological map, current node, step counter.
- `NavServer`   - dynamic batcher: concurrent `step()` calls are
  coalesced (up to `max_batch` or `max_wait_ms`) into ONE perceive call
  + ONE navigation-scoring call on the agent's device, then translated
  per-session into high-level actions.

Serving choices kept from the JAX package:
- fixed shapes: the device batch is always padded to `max_batch` slots
  (empty slots carry zeros and are discarded), and navigation scoring
  runs at the smallest gmap-length bucket (PLANNER.gmap_len_buckets)
  that holds the largest live graph; `warmup()` runs every program once
  (text encoder, perception, one scoring call per bucket) so the first
  requests do not pay the kernels' build and the allocator's growth;
- all stepping happens on the single batcher thread; `create_session`
  runs the text encoder from the calling thread;
- map updates + action translation (the only Python logic) run between
  the two device calls.

While tracing is on (`utils/logging.py`) a request's wait from `step()`
to the batcher's claim is the span `serve.queue_wait` on the client's
thread (key (sid, step), with the id of the batch that claimed it); the
batcher's `_collect` is `serve.collect` and `_process` is `serve.batch`
(key: the batch id) with the consecutive children `serve.stage`,
`serve.perceive`, `serve.map`, `serve.score` and `serve.translate`;
`create_session`'s text encoding is `serve.encode_text` (key: the sid),
which holds the agent's `agent.text_llm` with the DeepSeek-V2 encoder.

Returned actions use the env-action dict vocabulary of the rollout
engine / env layer (environments.py:436-477 semantics): act 0 = stop at
`stop_pos` (optionally walking `back_path`), act 4 = go to `ghost_pos`
via `front_pos`.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from etpnav_tpu_torch.config import ExperimentConfig, pick_bucket
from etpnav_tpu_torch.graph.topo_map import TopoMap
from etpnav_tpu_torch.training.agent import Agent
from etpnav_tpu_torch.training.rollout import (
    _fit,
    _softmax,
    build_env_action,
)
from etpnav_tpu_torch.utils import logging as tracing


@dataclass
class NavSession:
    sid: int
    txt_embeds: np.ndarray          # (L, Dh) fp32
    txt_mask: np.ndarray            # (L,) bool
    gmap: TopoMap
    prev_node: Optional[int] = None
    stepk: int = 0
    done: bool = False
    in_flight: bool = False         # at most one step() per session
    history: List[dict] = field(default_factory=list)


@dataclass
class _Pending:
    session: NavSession
    rgb: np.ndarray
    depth: np.ndarray
    pos: np.ndarray
    ori: np.ndarray
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    cancelled: bool = False         # set by a timed-out/aborted caller
    claimed: bool = False           # set by the batcher once processing
                                    # is committed; guarded by server lock
    stepk: int = 0                  # the session's step it asks for
    t_enqueued: float = 0.0         # perf_counter when queued
    thread: int = 0                 # the caller's thread
    batch_id: int = -1              # the batch that claimed it


class NavServer:
    """Dynamic-batching navigation service over an `Agent`.

    Thread-safe: `create_session` / `step` / `close_session` may be
    called from any number of client threads. A single batcher thread
    owns the device. With no `agent`, one with seeded random weights is
    built on `device` (the GPU unless `device="cpu"`; raises when there
    is none).
    """

    def __init__(self, cfg: ExperimentConfig, agent: Optional[Agent] = None,
                 *, max_batch: int = 8, max_wait_ms: float = 5.0,
                 max_steps: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        self.agent = agent if agent is not None else Agent(cfg,
                                                           device=device)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_steps = max_steps or cfg.il.max_traj_len
        self._sessions: Dict[int, NavSession] = {}
        self._sid = itertools.count()
        self._lock = threading.Lock()
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        # observability counters (stats()); guarded by _lock
        self._steps_served = 0
        self._batches = 0
        self._failed_batches = 0
        self._deadline_batches = 0
        self._batch_ids = itertools.count()
        self._thread = threading.Thread(target=self._batch_loop,
                                        daemon=True)
        self._thread.start()

    # -- session lifecycle --------------------------------------------------

    def warmup(self) -> int:
        """Run every device program once before taking traffic: the text
        encoder, perception, and one navigation-scoring call per
        gmap-length bucket (plus the full length). The first call builds
        the CUDA kernels and grows the allocator's pools, and perception
        captures the whole perceive as one CUDA graph at the static batch
        (`Agent.perceive`: two inputs, rgb and depth, whose shapes,
        strides and dtypes key the graph; its warm-up run captures the
        depth trunk's own graph, which the eager perceive of a traced or
        profiled stretch replays). Every served batch is padded to
        `max_batch`, so it replays that one graph whatever its load;
        calling this at deploy time keeps all of it out of live request
        latency. Returns the number of programs warmed."""
        cfg = self.cfg
        Bs = self.max_batch
        L = cfg.il.max_text_len
        Dh = cfg.planner.hidden_size
        ids = np.full((1, L), cfg.planner.pad_token_id, np.int32)
        mask = np.zeros((1, L), bool)
        mask[:, 0] = True
        self.agent.encode_text(ids, mask)
        rgb = np.zeros((Bs, 12, cfg.clip.image_size, cfg.clip.image_size,
                        3), np.uint8)
        dep = np.zeros((Bs, 12, cfg.depth.input_size,
                        cfg.depth.input_size, 1), np.float32)
        self.agent.perceive(rgb, dep)
        buckets = list(cfg.planner.gmap_len_buckets or ())
        lengths = sorted({*buckets, cfg.planner.max_gmap_len})
        txt_e = np.zeros((Bs, L, Dh), np.float32)
        txt_m = np.zeros((Bs, L), bool)
        txt_m[:, 0] = True
        for G in lengths:
            gmap = {
                "img_fts": np.zeros((Bs, G, Dh), np.float32),
                "step_ids": np.zeros((Bs, G), np.int32),
                "pos_fts": np.zeros((Bs, G, 7), np.float32),
                "mask": np.zeros((Bs, G), bool),
                "visited": np.zeros((Bs, G), bool),
                "pair_dists": np.zeros((Bs, G, G), np.float32),
            }
            gmap["mask"][:, 0] = True
            self.agent.score_navigation(txt_e, txt_m, gmap)
        return 2 + len(lengths)

    def create_session(self, instruction_tokens: np.ndarray) -> int:
        """Encode the instruction (one (1, L) dispatch) and register a
        fresh episode. Returns the session id."""
        cfg = self.cfg
        sid = next(self._sid)
        with tracing.span("serve.encode_text", key=sid):
            ids = _fit(np.asarray(instruction_tokens), cfg.il.max_text_len,
                       cfg.planner.pad_token_id)[None]
            mask = ids != cfg.planner.pad_token_id
            embeds = _host(self.agent.encode_text(ids, mask))[0]
        ses = NavSession(
            sid=sid, txt_embeds=embeds, txt_mask=mask[0],
            gmap=TopoMap(loc_noise=cfg.il.loc_noise,
                         merge_ghost=cfg.graph.merge_ghost))
        with self._lock:
            self._sessions[ses.sid] = ses
        return ses.sid

    def step(self, sid: int, rgb: np.ndarray, depth: np.ndarray,
             pos: np.ndarray, ori_xyzw: np.ndarray,
             timeout: Optional[float] = 600.0) -> dict:
        """Submit one observation; blocks until the batched result.

        rgb (12, H, W, 3) uint8 ccw views; depth (12, Hd, Wd, 1) in
        [0,1]; pos (3,) world position; ori_xyzw (4,) quaternion.
        Returns {"action": env-action dict, "done": bool, "stop_prob":
        float, "num_nodes": int, "num_ghosts": int}.

        The default timeout covers a cold start (the first call builds
        the CUDA kernels). At most one step may be in flight per
        session (a concurrent second call raises). On timeout the
        request is cancelled: if the batcher has not yet committed to
        processing it, it is skipped and the session stays usable; if it
        was already committed, the observation may be registered
        server-side, so the session is marked done (poisoned) — a retry
        would register the same observation twice.
        """
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        rgb = np.asarray(rgb)
        depth = np.asarray(depth)
        pos = np.asarray(pos, np.float64)
        ori_xyzw = np.asarray(ori_xyzw, np.float64)
        self._validate_obs(rgb, depth, pos, ori_xyzw)
        with self._lock:
            ses = self._sessions[sid]
            if ses.done:
                raise RuntimeError(f"session {sid} already stopped")
            if ses.in_flight:
                raise RuntimeError(
                    f"session {sid} already has a step in flight")
            ses.in_flight = True
        p = _Pending(ses, rgb, depth, pos, ori_xyzw, stepk=ses.stepk,
                     t_enqueued=time.perf_counter(),
                     thread=threading.get_ident())
        try:
            self._queue.put(p)
            if not p.event.wait(timeout):
                with self._lock:
                    p.cancelled = True
                    if p.claimed:
                        # the batcher committed to this request: the map
                        # update may happen (or have happened) server-side,
                        # so a retry would double-register — enforce the
                        # fatal-timeout contract instead of relying on
                        # client discipline
                        ses.done = True
                raise TimeoutError(f"step for session {sid} timed out")
            if isinstance(p.result, Exception):
                raise p.result
            return p.result
        finally:
            with self._lock:
                ses.in_flight = False

    def _validate_obs(self, rgb: np.ndarray, depth: np.ndarray,
                      pos: np.ndarray, ori_xyzw: np.ndarray) -> None:
        """Reject malformed observations at the door, so one bad client
        can never poison the co-batched sessions (the device batch is
        sized from cfg, and everything reaching _process conforms)."""
        cfg = self.cfg
        want_rgb = (12, cfg.clip.image_size, cfg.clip.image_size, 3)
        want_dep = (12, cfg.depth.input_size, cfg.depth.input_size, 1)
        if tuple(rgb.shape) != want_rgb:
            raise ValueError(f"rgb shape {rgb.shape} != {want_rgb}")
        if tuple(depth.shape) != want_dep:
            raise ValueError(f"depth shape {depth.shape} != {want_dep}")
        if pos.shape != (3,):
            raise ValueError(f"pos shape {pos.shape} != (3,)")
        if ori_xyzw.shape != (4,):
            raise ValueError(f"ori shape {ori_xyzw.shape} != (4,)")

    def stats(self) -> dict:
        """Service counters: steps served, successful device dispatches,
        failed dispatches, the batches that `max_wait_ms` closed before
        they were full (deadline_batches: tune `max_wait_ms` by it), mean
        batch occupancy (slots used / max_batch — the device batch is
        always padded to max_batch), live sessions, and current queue
        depth. Counters reflect SUCCESSFUL batches only — a failing
        dispatch poisons its sessions and increments failed_batches
        instead. The agent's graph counters come with them: the whole
        perceive's (`Agent.perceive_graph_stats`: perceive_graph_replays,
        perceive_eager_calls, perceive_graph_captures), the depth
        trunk's (`Agent.depth_graph_stats`: depth_graph_replays,
        depth_eager_calls, depth_graph_captures); and its text counters
        (`Agent.text_stats`): text_encodes, text_tokens, and the
        DeepSeek-V2 encoder's moe_rows, moe_groups, moe_rows_elsewhere.
        The text counters are device counters, so this call waits for
        the device."""
        with self._lock:
            batches = self._batches
            steps = self._steps_served
            failed = self._failed_batches
            deadline = self._deadline_batches
            live = sum(1 for s in self._sessions.values() if not s.done)
        occ = steps / (batches * self.max_batch) if batches else 0.0
        return {"steps_served": steps, "batches": batches,
                "failed_batches": failed, "deadline_batches": deadline,
                "mean_occupancy": round(occ, 4),
                "live_sessions": live,
                "queue_depth": self._queue.qsize(),
                **self.agent.perceive_graph_stats(),
                **self.agent.depth_graph_stats(),
                **self.agent.text_stats()}

    def close_session(self, sid: int) -> dict:
        with self._lock:
            if sid not in self._sessions:
                raise KeyError(f"unknown session {sid}")
            ses = self._sessions[sid]
            if ses.in_flight:
                # closing under a blocked step would hand the caller a
                # history the batcher is still appending to
                raise RuntimeError(
                    f"session {sid} already has a step in flight")
            del self._sessions[sid]
        # copy: the session object may still be referenced by telemetry;
        # the returned record must be final
        return {"steps": ses.stepk, "history": list(ses.history)}

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self._drain_queue(RuntimeError("server is shut down"))

    def _drain_queue(self, exc: Exception):
        """Fail any still-queued requests promptly instead of letting
        their callers block out their full timeout."""
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                return
            if not p.event.is_set():
                p.result = exc
                p.event.set()

    # -- batcher ------------------------------------------------------------

    def _collect(self) -> Tuple[List[_Pending], float]:
        """The next batch and the perf_counter time its first request was
        taken: the first to arrive, then any more until the batch is full
        or `max_wait_ms` after the first."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return [], 0.0
        t_first = time.perf_counter()
        batch = [first]
        deadline = _now() + self.max_wait_s
        while len(batch) < self.max_batch:
            left = deadline - _now()
            if left <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=left))
            except queue.Empty:
                break
        return batch, t_first

    def _batch_loop(self):
        while not self._stop.is_set():
            batch, t_first = self._collect()
            t_closed = time.perf_counter()
            full = len(batch) == self.max_batch
            # claim under the lock: after this point a timed-out caller
            # knows its observation may be registered server-side (and
            # poisons its session); before it, cancellation is clean
            with self._lock:
                batch = [p for p in batch if not p.cancelled]
                for p in batch:
                    p.claimed = True
            if not batch:
                continue
            bid = next(self._batch_ids)
            t_claim = time.perf_counter()
            tracing.record("serve.collect", t_first, t_closed, key=bid,
                           full=full)
            for p in batch:
                p.batch_id = bid
                tracing.record("serve.queue_wait", p.t_enqueued, t_claim,
                               key=(p.session.sid, p.stepk),
                               thread=p.thread, batch=bid)
            try:
                self._process(batch)
                # counters move BEFORE any client event fires: a caller
                # may read stats() the instant it unblocks
                with self._lock:
                    self._batches += 1
                    self._deadline_batches += not full
                    self._steps_served += len(batch)
                for p in batch:
                    p.event.set()
            except Exception as e:
                with self._lock:
                    self._failed_batches += 1
                # surface the failure to callers still waiting; their
                # sessions may already be partially updated (the map
                # update runs before scoring), so poison them — a retry
                # would register the same observation twice
                for p in batch:
                    if not p.event.is_set():
                        p.session.done = True
                        p.result = e
                        p.event.set()
        self._drain_queue(RuntimeError("server is shut down"))

    def _process(self, batch: List[_Pending]):
        """Run the two device dispatches and fill each request's result.

        Does NOT set completion events — the batcher does that after the
        service counters move, so stats() is consistent the moment a
        client unblocks."""
        with tracing.span("serve.batch", key=batch[0].batch_id), \
                tracing.sequence() as seq:
            seq.next("serve.stage")
            cfg = self.cfg
            n = len(batch)
            Bs = self.max_batch                   # static device batch
            # sized from cfg, not from batch[0]: every request was validated
            # at step() entry, so the device shapes are load-independent
            rgb = np.zeros((Bs, 12, cfg.clip.image_size, cfg.clip.image_size,
                            3), np.uint8)
            dep = np.zeros((Bs, 12, cfg.depth.input_size,
                            cfg.depth.input_size, 1), np.float32)
            for i, p in enumerate(batch):
                rgb[i] = p.rgb
                dep[i] = p.depth

            # ---- dispatch 1: fused perception over the padded slots ----
            seq.next("serve.perceive")
            wp = self.agent.perceive(rgb, dep)
            wp_h = {k: _host(wp[k]) for k in
                    ("cand_valid", "cand_angles", "cand_distances")}
            pano_embeds = _host(wp["pano_embeds"])
            avg_pano = _host(wp["avg_pano_embeds"])

            # ---- host: topo-map updates + padded graph emission ----
            seq.next("serve.map")
            G = cfg.planner.max_gmap_len
            Dh = cfg.planner.hidden_size
            emits = []
            for i, p in enumerate(batch):
                ses = p.session
                valid = wp_h["cand_valid"][i]
                tok_idx = np.flatnonzero(valid)
                ses.prev_node = ses.gmap.update(
                    ses.prev_node, ses.stepk + 1, p.pos, p.ori,
                    avg_pano[i], wp_h["cand_angles"][i][valid],
                    wp_h["cand_distances"][i][valid],
                    pano_embeds[i][tok_idx], tok_idx, ses.stepk)
                ses.stepk += 1
            need = max(1 + p.session.gmap.num_nodes
                       + len(p.session.gmap.ghosts) for p in batch)
            G_step = pick_bucket(need, cfg.planner.gmap_len_buckets, G)
            for p in batch:
                ses = p.session
                emits.append(ses.gmap.emit(ses.prev_node, p.pos, p.ori,
                                           G_step, Dh))
            pad_emit = {k: np.zeros_like(emits[0][k])
                        for k in ("img_fts", "step_ids", "pos_fts", "mask",
                                  "visited", "pair_dists")}
            gmap_batch = {
                k: np.stack([e[k] for e in emits]
                            + [pad_emit[k]] * (Bs - n))
                for k in pad_emit}
            L = cfg.il.max_text_len
            txt_e = np.zeros((Bs, L, self.cfg.planner.hidden_size),
                             np.float32)
            txt_m = np.zeros((Bs, L), bool)
            for i, p in enumerate(batch):
                txt_e[i] = p.session.txt_embeds
                txt_m[i] = p.session.txt_mask
            # empty slots need one valid token / node for finite softmax
            txt_m[n:, 0] = True
            gmap_batch["mask"][n:, 0] = True

            # ---- dispatch 2: navigation scoring ----
            seq.next("serve.score")
            nav = self.agent.score_navigation(txt_e, txt_m, gmap_batch)
            logits = _host(nav["global_logits"])[:n]
            probs = _softmax(logits)

            # ---- per-session action translation (shared with rollout) ----
            seq.next("serve.translate")
            for i, p in enumerate(batch):
                ses = p.session
                gmap = ses.gmap
                gmap.node_stop_scores[ses.prev_node] = float(probs[i, 0])
                action, new_prev, is_stop, _ = build_env_action(
                    cfg, gmap, emits[i], int(logits[i].argmax()),
                    ses.prev_node, force_stop=ses.stepk >= self.max_steps)
                ses.prev_node = new_prev
                # under the lock, and never clearing: a client that timed out
                # after the claim has poisoned the session meanwhile
                with self._lock:
                    ses.done = ses.done or is_stop
                    done = ses.done
                ses.history.append({"step": ses.stepk,
                                    "pos": p.pos.tolist(),
                                    "stop_prob": float(probs[i, 0])})
                p.result = {"action": action, "done": done,
                            "stop_prob": float(probs[i, 0]),
                            "num_nodes": gmap.num_nodes,
                            "num_ghosts": len(gmap.ghosts)}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _now() -> float:
    return time.monotonic()
