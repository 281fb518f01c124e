"""Rollout engine: the host-driven episode loop over the agent's device
programs (counterpart of `etpnav_tpu/training/rollout.py`).

1. Rollout (this file): step the envs with the inference-only programs
   of `Agent`, maintain per-env TopoMaps host-side, and record every
   input needed to replay the differentiable path: frozen vp token
   features, padded graph arrays, the sparse record of the linear
   aggregation that maps pano tokens to graph node features, and teacher
   actions.
2. Learn (training/finetune.py): one training step recomputes the
   text/pano/navigation encoders over all recorded steps at once and
   backpropagates.

`build_env_action`, `_fit` and `_softmax` are shared with `serving.py`.

While tracing is on (`utils/logging.py`) `run` marks its work as
consecutive spans keyed (iteration, step), the iteration being the key
of the span the caller has open (the trainer's `train.rollout`): before
the first step `rollout.env` (reset), `rollout.text` (the instruction
encoding) and `rollout.record` (the record's and maps' allocation); in
every step `rollout.perceive` (stack, upload, perceive, fetch),
`rollout.map` (map updates, emission, the batch's graph arrays),
`rollout.score` (scoring, fetch, stop scores), `rollout.teacher`,
`rollout.record` (the record fill, the action choice and the env
actions) and `rollout.env` (`envs.step`, the finished episodes and the
next step's pose read).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from etpnav_tpu_torch import native
from etpnav_tpu_torch.config import ExperimentConfig, pick_bucket
from etpnav_tpu_torch.graph.topo_map import TopoMap
from etpnav_tpu_torch.metrics import episode_metrics
from etpnav_tpu_torch.training.agent import Agent
from etpnav_tpu_torch.utils import logging as tracing

# perceive outputs the host reads each step
_HOST_KEYS = ("cand_valid", "cand_angles", "cand_distances", "cand_img_idx",
              "rgb_fts", "dep_fts", "loc_fts", "nav_types", "view_masks",
              "pano_embeds", "avg_pano_embeds")


@dataclasses.dataclass
class RolloutRecord:
    """Fixed-shape recording of one rollout interval for the learn phase."""
    txt_ids: np.ndarray        # (B, L)
    txt_masks: np.ndarray      # (B, L)
    vp_rgb: np.ndarray         # (B, T, P, Dr)
    vp_dep: np.ndarray         # (B, T, P, Dd)
    vp_loc: np.ndarray         # (B, T, P, 4)
    vp_nav: np.ndarray         # (B, T, P)
    vp_mask: np.ndarray        # (B, T, P)
    # Sparse aggregation record: a node slot averages exactly one step's
    # valid tokens (its visit-step index, -1 for stop/ghost/empty slots);
    # a ghost slot averages its (step, token) provenance entries, at most
    # T * max_predictions = M of them over all ghosts of a step.
    agg_node_step: np.ndarray  # (B, T, G) int32, -1 = not a node slot
    agg_ent_slot: np.ndarray   # (B, T, M) int32 gmap slot (0-padded)
    agg_ent_tok: np.ndarray    # (B, T, M) int32 flat token t*P+tok
    agg_ent_val: np.ndarray    # (B, T, M) f32 share weight (0 = padding)
    gmap_step_ids: np.ndarray  # (B, T, G)
    gmap_pos_fts: np.ndarray   # (B, T, G, 7)
    gmap_mask: np.ndarray      # (B, T, G)
    gmap_visited: np.ndarray   # (B, T, G)
    gmap_pair: np.ndarray      # (B, T, G, G)
    teacher: np.ndarray        # (B, T) int32, -100 = ignore
    step_valid: np.ndarray     # (B, T) bool
    logits: np.ndarray         # (B, T, G) rollout-time nav logits (replay
                               # equivalence checks)


def fetch(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device tensors -> numpy in ONE synchronising step: every copy is
    queued (non_blocking, into pinned host memory) before the one wait,
    instead of one round trip per tensor."""
    host = {}
    for key, t in tensors.items():
        if t.is_floating_point() and t.dtype != torch.float32:
            t = t.float()
        host[key] = t.to("cpu", non_blocking=True)
    for t in tensors.values():
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()
            break
    return {k: v.numpy() for k, v in host.items()}


class RolloutEngine:
    def __init__(self, cfg: ExperimentConfig, agent: Agent, envs,
                 seed: int = 0):
        self.cfg = cfg
        self.agent = agent
        self.envs = envs
        # numpy stream: TopoMap noise, ghost_aug, teacher draws and the
        # schedule-sampled action choice, in the JAX package's call order
        self.np_rng = np.random.default_rng(seed)
        # torch stream: the waypoint augmentation's draws (on the device)
        self.generator = torch.Generator(
            device=agent.device).manual_seed(seed)
        self.last_gmap_stats: List[dict] = []

    # ------------------------------------------------------------------ run

    def run(self, mode: str, sample_ratio: float = 0.0,
            gt_paths: Optional[Dict[str, np.ndarray]] = None,
            stat_eps: Optional[dict] = None,
            path_eps: Optional[dict] = None,
            sample_actions: bool = False,
            video_dir: Optional[str] = None) -> Optional[RolloutRecord]:
        """One interval: reset all envs, run episodes to completion.

        mode: 'train' records a RolloutRecord; 'eval' fills stat_eps with
        metrics; 'infer' fills path_eps with recorded paths.
        sample_actions: in eval/infer, sample the policy's softmax instead
        of argmax (INFERENCE.SAMPLE, ss_trainer_ETP.py:895-903).
        video_dir: in eval, write one navigator video per episode —
        pano strip over a top-down map with the topo graph (the VIDEO_DIR
        pipeline, environments.py:486-516 + utils.py:647-752;
        `utils/visualization.py`).
        """
        with tracing.sequence() as seq:
            it = tracing.current_key()
            seq.next("rollout.env", key=(it, -1))
            cfg = self.cfg
            il = cfg.il
            envs = self.envs
            envs.resume_all()
            obs_list = envs.reset()
            # every device program runs at the full pool size B for the whole
            # interval: paused and finished envs ride along as padding rows on
            # their last observation / a masked zero graph (rows are
            # independent, so live rows are the same either way)
            B = envs.num_envs
            episodes = envs.current_episodes()
            live = list(range(B))

            seen = (stat_eps if mode == "eval" and stat_eps is not None
                    else path_eps if mode == "infer" and path_eps is not None
                    else None)
            if seen is not None:
                to_pause = [i for i, ep in enumerate(episodes)
                            if ep.episode_id in seen]
                for i in reversed(to_pause):
                    envs.pause_at(i)
                    live.remove(i)
                if envs.num_envs == 0:
                    return None
            obs_full = list(obs_list)
            pos, ori = envs.get_pos_ori()
            L = il.max_text_len
            T = il.max_traj_len
            P = cfg.waypoint.max_predictions + 12
            G = cfg.planner.max_gmap_len
            Dr = cfg.planner.image_feat_size
            Dd = cfg.planner.depth_feat_size
            Dh = cfg.planner.hidden_size

            seq.next("rollout.text")
            txt_ids = np.stack([
                _fit(o["instruction"], L, cfg.planner.pad_token_id)
                for o in obs_list])
            txt_masks = txt_ids != cfg.planner.pad_token_id
            txt_embeds_all = self.agent.encode_text(txt_ids, txt_masks)

            seq.next("rollout.record")
            train = mode == "train"
            rec = None
            if train:
                M = T * cfg.waypoint.max_predictions
                rec = RolloutRecord(
                    txt_ids=txt_ids, txt_masks=txt_masks,
                    vp_rgb=np.zeros((B, T, P, Dr), np.float32),
                    vp_dep=np.zeros((B, T, P, Dd), np.float32),
                    vp_loc=np.zeros((B, T, P, 4), np.float32),
                    vp_nav=np.zeros((B, T, P), np.int32),
                    vp_mask=np.zeros((B, T, P), bool),
                    agg_node_step=np.full((B, T, G), -1, np.int32),
                    agg_ent_slot=np.zeros((B, T, M), np.int32),
                    agg_ent_tok=np.zeros((B, T, M), np.int32),
                    agg_ent_val=np.zeros((B, T, M), np.float32),
                    gmap_step_ids=np.zeros((B, T, G), np.int32),
                    gmap_pos_fts=np.zeros((B, T, G, 7), np.float32),
                    gmap_mask=np.zeros((B, T, G), bool),
                    gmap_visited=np.zeros((B, T, G), bool),
                    gmap_pair=np.zeros((B, T, G, G), np.float32),
                    teacher=np.full((B, T), -100, np.int32),
                    step_valid=np.zeros((B, T), bool),
                    logits=np.zeros((B, T, G), np.float32),
                )

            gmaps = [TopoMap(loc_noise=il.loc_noise,
                             merge_ghost=cfg.graph.merge_ghost,
                             ghost_aug=il.ghost_aug if train else 0.0,
                             track_real_pos=train,
                             rng=self.np_rng)
                     for _ in range(B)]
            # per-env ghost real positions for the teacher (gid -> [pos])
            ghost_real: List[Dict[int, list]] = [dict() for _ in range(B)]
            prev_node = [None] * B
            record_video = mode == "eval" and video_dir is not None
            video_frames: Dict[int, list] = {}
            video_traj: Dict[int, list] = {}

            for stepk in range(T):
                seq.next("rollout.perceive", key=(it, stepk))
                # full pool: padding rows re-encode their last observation;
                # the native parallel gather is the one host copy between
                # the workers' (shared-memory) observations and the upload
                rgb = native.stack_arrays([o["rgb"] for o in obs_full])
                depth = native.stack_arrays([o["depth"] for o in obs_full])
                if il.depth_transport_uint16 and depth.dtype == np.float32:
                    # half the upload bytes; the agent dequantizes on the
                    # device (agent.encode_panorama)
                    depth = (np.clip(depth, 0.0, 1.0) * 65535.0
                             + 0.5).astype(np.uint16)

                # ---- waypoint + pano perception, one host fetch ----
                wp = self.agent.perceive(
                    rgb, depth,
                    self.generator if (train and il.waypoint_aug) else None)
                wp_h = fetch({k: wp[k] for k in _HOST_KEYS})
                pano_embeds = wp_h["pano_embeds"]
                avg_pano = wp_h["avg_pano_embeds"]

                # ---- update topological maps (host, live envs only) ----
                seq.next("rollout.map")
                cand_ad = []
                for gi in live:
                    valid = wp_h["cand_valid"][gi]
                    cand_ad.append((wp_h["cand_angles"][gi][valid],
                                    wp_h["cand_distances"][gi][valid]))
                batch_real_pos = None
                if train and hasattr(envs, "cand_real_pos_batch"):
                    batch_real_pos = envs.cand_real_pos_batch(
                        [a for a, _ in cand_ad], [d for _, d in cand_ad])
                for i, gi in enumerate(live):
                    valid = wp_h["cand_valid"][gi]
                    angles, dists = cand_ad[i]
                    # cand slot == token idx
                    tok_idx = np.flatnonzero(valid)
                    cand_embeds = pano_embeds[gi][tok_idx]
                    real_pos = None
                    if train:
                        real_pos = (batch_real_pos[i]
                                    if batch_real_pos is not None
                                    else envs.cand_real_pos(i, angles, dists))
                    cur = gmaps[gi].update(
                        prev_node[gi], stepk + 1, pos[i], ori[i], avg_pano[gi],
                        angles, dists, cand_embeds, tok_idx, stepk,
                        cand_real_pos=real_pos)
                    if train and real_pos is not None:
                        # per-ghost real positions for the spl expert
                        # (graph_utils.py:225-246 ghost_real_pos)
                        tok_to_ci = {int(t): ci
                                     for ci, t in enumerate(tok_idx)}
                        for gid, g in gmaps[gi].ghosts.items():
                            for (st, tok) in g.provenance:
                                if st == stepk and tok in tok_to_ci:
                                    lst = ghost_real[gi].setdefault(gid, [])
                                    lst.append(real_pos[tok_to_ci[tok]])
                    prev_node[gi] = cur

                # ---- emit padded graph arrays, batch, score ----
                # eval/infer emit at the smallest gmap bucket that fits every
                # live graph; training emits at G (the record is one shape)
                G_step = G
                if not train and cfg.planner.gmap_len_buckets:
                    need = max(1 + gmaps[gi].num_nodes
                               + len(gmaps[gi].ghosts) for gi in live)
                    G_step = pick_bucket(need, cfg.planner.gmap_len_buckets, G)
                emits = [gmaps[gi].emit(prev_node[gi], pos[i], ori[i], G_step,
                                        Dh)
                         for i, gi in enumerate(live)]
                # full-pool batch: dead rows are zero graphs with one valid
                # slot so the masked softmax stays finite
                gmap_batch = {}
                for key in ("img_fts", "step_ids", "pos_fts", "mask",
                            "visited", "pair_dists"):
                    full = np.zeros((B,) + emits[0][key].shape,
                                    emits[0][key].dtype)
                    for i, gi in enumerate(live):
                        full[gi] = emits[i][key]
                    gmap_batch[key] = full
                dead = [gi for gi in range(B) if gi not in live]
                if dead:
                    gmap_batch["mask"][np.asarray(dead), 0] = True
                seq.next("rollout.score")
                nav = self.agent.score_navigation(txt_embeds_all, txt_masks,
                                                  gmap_batch)
                logits = fetch({"l": nav["global_logits"]})["l"]
                probs = _softmax(logits)

                # store stop score of current node (ss_trainer_ETP.py:881-882)
                for gi in live:
                    gmaps[gi].node_stop_scores[prev_node[gi]] = float(
                        probs[gi, 0])

                # ---- teacher actions (live envs) ----
                seq.next("rollout.teacher")
                n = len(live)
                teacher = np.full(n, -100, np.int32)
                if train:
                    cur_dist = envs.current_dist_to_goal()
                    for i, gi in enumerate(live):
                        teacher[i] = self._teacher_action(
                            i, gi, gmaps[gi], emits[i], cur_dist[i],
                            ghost_real[gi], episodes[gi], gt_paths)

                # ---- record ----
                seq.next("rollout.record")
                if train:
                    for i, gi in enumerate(live):
                        rec.step_valid[gi, stepk] = True
                        rec.teacher[gi, stepk] = teacher[i]
                        rec.logits[gi, stepk] = logits[gi]
                        rec.vp_rgb[gi, stepk] = wp_h["rgb_fts"][gi]
                        rec.vp_dep[gi, stepk] = wp_h["dep_fts"][gi]
                        rec.vp_loc[gi, stepk] = wp_h["loc_fts"][gi]
                        rec.vp_nav[gi, stepk] = wp_h["nav_types"][gi]
                        rec.vp_mask[gi, stepk] = wp_h["view_masks"][gi]
                        for arr, key in ((rec.gmap_step_ids, "step_ids"),
                                         (rec.gmap_pos_fts, "pos_fts"),
                                         (rec.gmap_mask, "mask"),
                                         (rec.gmap_visited, "visited"),
                                         (rec.gmap_pair, "pair_dists")):
                            arr[gi, stepk] = emits[i][key]
                        self._fill_agg_sparse(rec, gi, stepk, emits[i], P)

                # ---- choose actions (live envs) ----
                if train:
                    acts = np.empty(n, np.int64)
                    for i, gi in enumerate(live):
                        if self.np_rng.random() <= sample_ratio:
                            acts[i] = teacher[i] if teacher[i] >= 0 else 0
                        else:
                            acts[i] = self.np_rng.choice(logits.shape[1],
                                                         p=probs[gi])
                elif sample_actions:
                    acts = np.asarray([
                        self.np_rng.choice(logits.shape[1], p=probs[gi])
                        for gi in live])
                else:
                    acts = logits[np.asarray(live)].argmax(1)

                # ---- build env actions ----
                env_actions = []
                for i, gi in enumerate(live):
                    action, new_prev, _, consumed = build_env_action(
                        cfg, gmaps[gi], emits[i], int(acts[i]),
                        prev_node[gi], force_stop=stepk == T - 1)
                    env_actions.append(action)
                    prev_node[gi] = new_prev
                    if consumed is not None:
                        ghost_real[gi].pop(consumed, None)

                if record_video:
                    from etpnav_tpu_torch.utils.visualization import \
                        navigator_video_frame
                    for i, gi in enumerate(live):
                        gmap = gmaps[gi]
                        video_traj.setdefault(gi, []).append(
                            np.asarray(pos[i]))
                        gt = (np.asarray(gt_paths[episodes[gi].episode_id])
                              if gt_paths else
                              np.stack(episodes[gi].reference_path))
                        act = env_actions[i]
                        video_frames.setdefault(gi, []).append(
                            navigator_video_frame(
                                {"rgb": rgb[gi]},
                                agent_pos=pos[i],
                                trajectory=list(video_traj[gi]),
                                gt_path=list(gt), goal=gt[-1],
                                nodes=list(gmap.node_pos),
                                edges=[(gmap.node_pos[u], gmap.node_pos[v])
                                       for u, v in gmap.edge_list()],
                                predict_ghost=act.get("ghost_pos"),
                                ghosts=[g.aug_pos
                                        for g in gmap.ghosts.values()]))

                seq.next("rollout.env")
                results = envs.step(env_actions)

                # ---- metrics / path recording on done ----
                done_local = [i for i, r in enumerate(results) if r.done]
                if mode == "eval" and stat_eps is not None:
                    for i in done_local:
                        ep = episodes[live[i]]
                        info = results[i].info
                        if info.get("crashed"):
                            continue
                        gt = np.asarray(
                            gt_paths[ep.episode_id] if gt_paths else
                            np.stack(ep.reference_path))
                        stat_eps[ep.episode_id] = episode_metrics(
                            info["position"]["position"],
                            info["position"]["distance"], gt,
                            info["steps_taken"],
                            info["collisions"]["count"],
                            il.success_distance)
                        if record_video and video_frames.get(live[i]):
                            from etpnav_tpu_torch.utils.visualization import \
                                generate_video
                            m = stat_eps[ep.episode_id]
                            generate_video(
                                video_frames.pop(live[i]), video_dir,
                                str(ep.episode_id),
                                {"spl": m["spl"], "ndtw": m["ndtw"]})
                if mode == "infer" and path_eps is not None:
                    for i in done_local:
                        ep = episodes[live[i]]
                        info = results[i].info
                        if info.get("crashed"):
                            continue
                        pinf = info["position_infer"]
                        path = [{"position": pinf["position"][0],
                                 "heading": pinf["heading"][0],
                                 "stop": False}]
                        for p, h in zip(pinf["position"][1:],
                                        pinf["heading"][1:]):
                            if p != path[-1]["position"]:
                                path.append({"position": p, "heading": h,
                                             "stop": False})
                        path = path[:500]
                        path[-1]["stop"] = True
                        path_eps[ep.episode_id] = {
                            "path": path, "instruction_id": ep.instruction_id}

                # ---- pause finished envs (device batch stays at B) ----
                if done_local:
                    for i in reversed(done_local):
                        envs.pause_at(i)
                        live.pop(i)
                        results.pop(i)
                if envs.num_envs == 0:
                    break
                for i, r in enumerate(results):
                    obs_full[live[i]] = r.observation
                if stepk + 1 < T:
                    pos, ori = envs.get_pos_ori()

            # graph-capacity instrumentation: per-env peak raw slot count and
            # eviction totals for this interval
            self.last_gmap_stats = [
                {"peak_slots": g.peak_slots,
                 "evicted_ghosts": g.evicted_ghosts,
                 "evicted_nodes": g.evicted_nodes} for g in gmaps]
            return rec

    # ------------------------------------------------------------- helpers

    def _teacher_action(self, live_i: int, gi: int, gmap: TopoMap,
                        emit: dict, cur_dist: float,
                        ghost_real: Dict[int, list], episode,
                        gt_paths) -> int:
        """_teacher_action_new (ss_trainer_ETP.py:278-306)."""
        il = self.cfg.il
        if cur_dist < il.stop_distance:
            return 0
        if emit["no_ghost_left"]:
            return -100
        slot_of_ghost = {idx: si for si, (k, idx)
                         in enumerate(emit["slot_list"]) if k == "ghost"}
        gids = list(slot_of_ghost.keys())
        if il.expert_policy == "spl":
            dists = []
            for g in gids:
                positions = ghost_real.get(g)
                p = (positions[self.np_rng.integers(len(positions))]
                     if positions else gmap.ghosts[g].aug_pos)
                dists.append(self.envs.point_dist_to_goal(live_i, p))
            return slot_of_ghost[gids[int(np.argmin(dists))]]
        elif il.expert_policy == "ndtw":
            ref = (np.asarray(gt_paths[episode.episode_id]) if gt_paths
                   else np.stack(episode.reference_path))
            gpos = []
            for g in gids:
                positions = ghost_real.get(g)
                gpos.append(positions[self.np_rng.integers(len(positions))]
                            if positions else gmap.ghosts[g].aug_pos)
            k = self.envs.ghost_dist_to_ref(live_i, np.stack(gpos), ref)
            return slot_of_ghost[gids[int(k)]]
        raise NotImplementedError(il.expert_policy)

    def _fill_agg_sparse(self, rec: RolloutRecord, gi: int, stepk: int,
                         emit: dict, P: int):
        """Record the aggregation provenance for one step (sparse form):
        a node slot's visit step; a ghost slot's (step, token) entries,
        one table row each with share 1/len."""
        n = 0
        M = rec.agg_ent_val.shape[2]
        for si, prov in enumerate(emit["provenance"]):
            if prov is None:
                continue
            kind, data = prov
            if kind == "node":
                rec.agg_node_step[gi, stepk, si] = data
            else:
                entries = data
                share = 1.0 / len(entries)
                if n + len(entries) > M:
                    raise AssertionError(
                        f"ghost provenance overflow: {n + len(entries)} "
                        f"entries > M={M} (bound T*max_predictions "
                        "violated)")
                for (t, tok) in entries:
                    rec.agg_ent_slot[gi, stepk, n] = si
                    rec.agg_ent_tok[gi, stepk, n] = t * P + tok
                    rec.agg_ent_val[gi, stepk, n] = share
                    n += 1


def build_env_action(cfg, gmap: TopoMap, emit: dict, slot: int,
                     prev_node: int, *, force_stop: bool = False):
    """Translate a chosen graph slot into an env-action dict
    (environments.py:436-477 semantics).

    Returns (action, new_prev_node, is_stop, consumed_gid): act 0 stops
    at the best-stop-score node (walking back_path under back_algo ==
    'control'); act 4 moves to a ghost via its front node, consuming the
    ghost when GRAPH.consume_ghost.
    """
    il = cfg.il
    is_stop = slot == 0 or force_stop or emit["no_ghost_left"]
    if not is_stop:
        kind, idx = emit["slot_list"][slot]
        if kind != "ghost":   # visited slots are -inf; safety
            is_stop = True
    control = il.back_algo == "control"
    if is_stop:
        stop_node = int(np.argmax(gmap.node_stop_scores))
        back_path = ([(v, gmap.node_pos[v]) for v in
                      gmap.path(prev_node, stop_node)][1:]
                     if control else None)
        action = {"act": 0, "stop_pos": gmap.node_pos[stop_node],
                  "back_path": back_path, "tryout": il.tryout}
        return action, prev_node, True, None
    gid = idx
    _, front = gmap.front_to_ghost(gid)
    back_path = ([(v, gmap.node_pos[v]) for v in
                  gmap.path(prev_node, front)][1:]
                 if control else None)
    action = {"act": 4, "front_pos": gmap.node_pos[front],
              "ghost_pos": gmap.ghosts[gid].aug_pos,
              "back_path": back_path, "tryout": il.tryout}
    consumed = None
    if cfg.graph.consume_ghost:  # MODEL.consume_ghost
        gmap.delete_ghost(gid)
        consumed = gid
    return action, front, False, consumed


def _fit(tokens: np.ndarray, max_len: int, pad_id: int) -> np.ndarray:
    out = np.full(max_len, pad_id, tokens.dtype)
    n = min(len(tokens), max_len)
    out[:n] = tokens[:n]
    return out


def _softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=1, keepdims=True)
    e = np.exp(np.clip(x - m, -80, 0))
    e[~np.isfinite(x)] = 0.0
    return e / np.maximum(e.sum(1, keepdims=True), 1e-12)
