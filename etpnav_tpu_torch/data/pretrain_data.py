"""Pretraining data: offline text+trajectory samples over connectivity
graphs, with the MLM / SAP / MRC / OG proxy tasks (the port's own copy
of `etpnav_tpu/data/pretrain_data.py`, numpy only: the same seeds and the
same order of draws, so a batch equals the JAX package's element for
element).

Capability target: pretrain_src/pretrain_src/data/{dataset,tasks,loader}.py
— R2RTextPathData trajectory assembly (dataset.py:408-525), MLM masking
(tasks.py:12-52), SAP end-viewpoint sampling pos 0.2 / neg-in-path 0.4 /
neg-others 0.4 (tasks.py:286-293), and MetaLoader multinomial task mixing
(loader.py:18-88) — emitting fixed-shape padded numpy batches that go to
the device in one copy each.

`SyntheticNavWorld` generates connectivity graphs and features
procedurally (deterministic per scan); `data/mp3d_pretrain.py` serves the
same batch layout from real MP3D annotations and HDF5 feature stores.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from etpnav_tpu_torch.graph.geometry import angle_features

MAX_DIST = 30.0
MAX_STEP = 10.0


# ---------------------------------------------------------------------------
# synthetic connectivity world
# ---------------------------------------------------------------------------

class SyntheticNavWorld:
    """A 'scan': viewpoints on a plane, connectivity by proximity,
    deterministic per-viewpoint visual features."""

    def __init__(self, scan_seed: int, num_vps: int = 24,
                 image_feat_size: int = 512, depth_feat_size: int = 128,
                 num_views: int = 12, connect_radius: float = 4.0):
        g = np.random.default_rng(scan_seed)
        self.num_views = num_views
        self.pos = np.zeros((num_vps, 3))
        self.pos[:, 0] = g.uniform(-10, 10, num_vps)
        self.pos[:, 2] = g.uniform(-10, 10, num_vps)
        # connectivity: k nearest within radius, symmetric, connected chain
        d = np.linalg.norm(self.pos[:, None] - self.pos[None], axis=-1)
        self.adj: List[List[int]] = [[] for _ in range(num_vps)]
        for i in range(num_vps):
            order = np.argsort(d[i])
            picked = [int(j) for j in order[1:5] if d[i, j] < connect_radius]
            for j in picked:
                if j not in self.adj[i]:
                    self.adj[i].append(j)
                if i not in self.adj[j]:
                    self.adj[j].append(i)
        for i in range(1, num_vps):  # guarantee connectivity
            j = int(np.argmin(d[i, :i]))
            if j not in self.adj[i]:
                self.adj[i].append(j)
                self.adj[j].append(i)
        # APSP (scans are small; Floyd is fine and done once per scan)
        dist = np.full((num_vps, num_vps), 1e9)
        np.fill_diagonal(dist, 0.0)
        nxt = np.tile(np.arange(num_vps), (num_vps, 1))
        for i in range(num_vps):
            for j in self.adj[i]:
                dist[i, j] = d[i, j]
                nxt[i, j] = j
        for k in range(num_vps):
            via = dist[:, k][:, None] + dist[k, :][None, :]
            better = via < dist
            dist = np.where(better, via, dist)
            nxt = np.where(better, np.tile(nxt[:, k][:, None],
                                           (1, num_vps)), nxt)
        self.dist, self._next = dist, nxt
        self.hops = self._compute_hops()

        self._feat_seed = scan_seed * 7919
        self.image_feat_size = image_feat_size
        self.depth_feat_size = depth_feat_size

    def _compute_hops(self):
        n = len(self.pos)
        hops = np.zeros((n, n), np.int32)
        for i in range(n):
            for j in range(n):
                if i == j or self.dist[i, j] >= 1e8:
                    continue
                c, h = i, 0
                while c != j and h < n:
                    c = self._next[c, j]
                    h += 1
                hops[i, j] = h
        return hops

    def shortest_path(self, u: int, v: int) -> List[int]:
        out = [u]
        while u != v and len(out) <= len(self.pos):
            u = int(self._next[u, v])
            out.append(u)
        return out

    def view_features(self, vp: int) -> Tuple[np.ndarray, np.ndarray]:
        """(V, img_ft) CLIP + (V, dep_ft) depth features per view,
        deterministic (stands in for the HDF5 feature store)."""
        g = np.random.default_rng(self._feat_seed + vp)
        img = g.standard_normal(
            (self.num_views, self.image_feat_size)).astype(np.float32)
        dep = g.standard_normal(
            (self.num_views, self.depth_feat_size)).astype(np.float32)
        return img, dep

    def view_probs(self, vp: int, prob_size: int) -> np.ndarray:
        """(V, prob_size) soft class labels per view — the synthetic stand-in
        for the CLIP logit columns the reference stores next to the features
        (dataset.py:210: softmax of img_fts[:, image_feat_size:])."""
        g = np.random.default_rng(self._feat_seed + 31 * (vp + 1))
        logits = 3.0 * g.standard_normal((self.num_views, prob_size))
        e = np.exp(logits - logits.max(1, keepdims=True))
        return (e / e.sum(1, keepdims=True)).astype(np.float32)

    def objects(self, vp: int, num_objs: int) -> Tuple[np.ndarray,
                                                       np.ndarray, int]:
        """(num_objs, img_ft) object features, (num_objs,) headings, and the
        index of the 'target' object at this viewpoint (synthetic stand-in
        for REVERIE object annotations, dataset.py:228-247)."""
        g = np.random.default_rng(self._feat_seed + 101 * (vp + 1))
        fts = g.standard_normal(
            (num_objs, self.image_feat_size)).astype(np.float32)
        headings = g.uniform(0, 2 * np.pi, num_objs)
        target = int(g.integers(num_objs)) if num_objs else -1
        return fts, headings, target

    def heading_to(self, u: int, v: int) -> float:
        d = self.pos[v] - self.pos[u]
        return float(np.arctan2(-d[0], -d[2]) % (2 * np.pi))

    def view_of_heading(self, heading: float) -> int:
        """Which of the V discrete views covers a world heading
        (clockwise view idx convention like the MP3D 12-view rig)."""
        sector = 2 * np.pi / self.num_views
        return int(np.round(heading / sector)) % self.num_views


@dataclasses.dataclass
class TrajectorySample:
    scan_seed: int
    path: List[int]
    instr_tokens: np.ndarray
    end_is_goal: bool
    gt_next_vp: Optional[int]


# ---------------------------------------------------------------------------
# sampler -> fixed-shape batches
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PretrainShapes:
    max_txt_len: int = 80
    max_traj_steps: int = 8           # TRAIN_MAX_STEP analogue
    num_views: int = 12
    max_cands: int = 5
    max_gmap_len: int = 48
    image_feat_size: int = 512
    depth_feat_size: int = 128
    vocab_size: int = 30522
    mask_token_id: int = 103          # bert [MASK]
    pad_token_id: int = 0
    mask_vocab_range: Tuple[int, int] = (1996, 29611)  # tasks.py:59
    # MRC soft-label dim (CLIP logit columns in the reference HDF5,
    # dataset.py:210,363) + masking prob (r2r_pretrain_habitat.json)
    image_prob_size: int = 1000
    mrc_mask_prob: float = 0.15
    # object tokens per viewpoint for OG (REVERIE-style; 0 = disabled,
    # matching the ETPNav R2R/RxR pipeline which has no object features)
    num_objs: int = 0

    @property
    def tokens_per_step(self) -> int:
        return self.num_views + self.max_cands + self.num_objs

    @property
    def num_view_tokens(self) -> int:
        """Tokens that are camera views (cand slots + pano views)."""
        return self.num_views + self.max_cands


class PretrainSampler:
    """Generates SAP/MLM batches over synthetic scans."""

    def __init__(self, shapes: PretrainShapes, *, num_scans: int = 8,
                 seed: int = 0, scan_size: int = 24):
        self.sh = shapes
        self.rng = np.random.default_rng(seed)
        self.worlds = [SyntheticNavWorld(
            1000 + s, num_vps=scan_size,
            image_feat_size=shapes.image_feat_size,
            depth_feat_size=shapes.depth_feat_size,
            num_views=shapes.num_views) for s in range(num_scans)]

    # ---- single trajectory ----

    def _sample_traj(self, end_vp_type: Optional[str] = None
                     ) -> Tuple[SyntheticNavWorld, TrajectorySample]:
        """end_vp_type None -> SAP mixture (tasks.py:286-293); 'pos' ->
        always the full path (MrcDataset/OGDataset use end_vp_pos_ratio=1,
        tasks.py:163,378)."""
        w = self.worlds[self.rng.integers(len(self.worlds))]
        n = len(w.pos)
        while True:
            s, e = self.rng.integers(n, size=2)
            if s != e and w.dist[s, e] < 1e8 and w.hops[s, e] >= 2:
                break
        full_path = w.shortest_path(int(s), int(e))
        L = int(self.rng.integers(4, self.sh.max_txt_len))
        tokens = np.full(self.sh.max_txt_len, self.sh.pad_token_id, np.int64)
        tokens[:L] = self.rng.integers(
            self.sh.mask_vocab_range[0], self.sh.mask_vocab_range[1], L)
        # SAP end-vp sampling (tasks.py:286-293)
        r = self.rng.random()
        if end_vp_type == "pos" or r < 0.2 or len(full_path) <= 1:
            path = full_path
            end_is_goal = True
            gt_next = None
        else:
            end_idx = int(self.rng.integers(len(full_path) - 1))
            path = full_path[:end_idx + 1]
            end_is_goal = False
            gt_next = full_path[end_idx + 1]
        path = path[:self.sh.max_traj_steps]
        if not end_is_goal and gt_next in path:
            gt_next = None   # degenerate after truncation
        return w, TrajectorySample(0, path, tokens, end_is_goal, gt_next)

    def _assemble(self, w: SyntheticNavWorld, traj: TrajectorySample
                  ) -> Dict[str, np.ndarray]:
        """Trajectory -> fixed-shape arrays (dataset.py:408-525 semantics:
        cand tokens first, then non-cand views; gmap = [stop] + visited +
        unvisited-neighbor nodes; aggregation matrix instead of ragged
        feature re-walk)."""
        sh = self.sh
        T, P, G = sh.max_traj_steps, sh.tokens_per_step, sh.max_gmap_len
        S = T * P
        vp_img = np.zeros((T, P, sh.image_feat_size), np.float32)
        vp_dep = np.zeros((T, P, sh.depth_feat_size), np.float32)
        vp_loc = np.zeros((T, P, 4), np.float32)
        vp_nav = np.zeros((T, P), np.int32)
        vp_mask = np.zeros((T, P), bool)
        step_valid = np.zeros((T,), bool)

        path = traj.path
        visited: Dict[int, int] = {}
        unvisited: Dict[int, List[Tuple[int, int]]] = {}
        step_cands: List[List[int]] = []

        for t, vp in enumerate(path):
            img, dep = w.view_features(vp)
            cands = [c for c in w.adj[vp]][:sh.max_cands]
            step_cands.append(cands)
            # cand tokens
            for k, cvp in enumerate(cands):
                view = w.view_of_heading(w.heading_to(vp, cvp))
                vp_img[t, k] = img[view]
                vp_dep[t, k] = dep[view]
                h = w.heading_to(vp, cvp)
                vp_loc[t, k] = angle_features(np.array([h]),
                                              np.array([0.0]))[0]
                vp_nav[t, k] = 1
                vp_mask[t, k] = True
            # non-cand views
            used = {w.view_of_heading(w.heading_to(vp, c)) for c in cands}
            for v in range(sh.num_views):
                if v in used:
                    continue
                slot = sh.max_cands + v
                vp_img[t, slot] = img[v]
                vp_dep[t, slot] = dep[v]
                hv = v * 2 * np.pi / sh.num_views
                vp_loc[t, slot] = angle_features(np.array([hv]),
                                                 np.array([0.0]))[0]
                vp_mask[t, slot] = True
            # object tokens after the views (REVERIE layout,
            # dataset.py:228-250: nav_type 2, angle loc features)
            if sh.num_objs > 0:
                obj_fts, obj_headings, _ = w.objects(vp, sh.num_objs)
                base = sh.num_view_tokens
                for j in range(sh.num_objs):
                    vp_img[t, base + j] = obj_fts[j]
                    vp_loc[t, base + j] = angle_features(
                        np.array([obj_headings[j]]), np.array([0.0]))[0]
                    vp_nav[t, base + j] = 2
                    vp_mask[t, base + j] = True
            step_valid[t] = True
            visited[vp] = t + 1
            unvisited.pop(vp, None)
            for k, cvp in enumerate(cands):
                if cvp not in visited:
                    unvisited.setdefault(cvp, []).append((t, k))

        # ---- gmap ----
        slots = ([("stop", -1)] + [("node", vp) for vp in visited]
                 + [("ghost", vp) for vp in unvisited])
        slots = slots[:G]
        gmap_step = np.zeros((G,), np.int32)
        gmap_visited = np.zeros((G,), bool)
        gmap_mask = np.zeros((G,), bool)
        gmap_pos = np.zeros((G, 7), np.float32)
        pair = np.zeros((G, G), np.float32)
        agg_w = np.zeros((G, S), np.float32)

        cur = path[-1]
        cur_heading = w.heading_to(path[-2], path[-1]) if len(path) > 1 \
            else 0.0
        slot_vps = []
        for si, (kind, vp) in enumerate(slots):
            gmap_mask[si] = True
            if kind == "stop":
                gmap_pos[si, :4] = angle_features(np.zeros(1), np.zeros(1))[0]
                slot_vps.append(None)
                continue
            slot_vps.append(vp)
            if kind == "node":
                gmap_step[si] = visited[vp]
                gmap_visited[si] = True
                t = visited[vp] - 1
                valid = vp_mask[t]
                agg_w[si, t * P:(t + 1) * P][valid] = 1.0 / valid.sum()
            else:
                for (t, k) in unvisited[vp]:
                    agg_w[si, t * P + k] += 1.0 / len(unvisited[vp])
            # pos features (dataset.py:325-345)
            gmap_pos[si] = _rel7(w, cur, vp, cur_heading)
        vp_arr = np.asarray([v for v in slot_vps[1:]], np.int64)
        if len(vp_arr):
            block = w.dist[np.ix_(vp_arr, vp_arr)] / MAX_DIST
            np.fill_diagonal(block, 0.0)
            pair[1:len(slots), 1:len(slots)] = block

        # ---- SAP label (dataset.py:390-406) ----
        if traj.end_is_goal:
            act_label = 0
        else:
            act_label = -100
            if traj.gt_next_vp is not None:
                for si, vp in enumerate(slot_vps):
                    if vp == traj.gt_next_vp and not gmap_visited[si]:
                        act_label = si
                        break

        # ---- local-branch vp position features (dataset.py:348-357):
        # [stop] + final-step tokens; [:7] = start rel. to cur for every
        # row, [7:] = candidate rel. to cur on cand rows only ----
        vp_pos = np.zeros((1 + P, 14), np.float32)
        vp_pos[:, :7] = _rel7(w, cur, path[0], cur_heading)
        for k, cvp in enumerate(step_cands[-1]):
            vp_pos[1 + k, 7:] = _rel7(w, cur, cvp, cur_heading)

        sample = {
            "txt_ids": traj.instr_tokens.copy(),
            "vp_img": vp_img, "vp_dep": vp_dep, "vp_loc": vp_loc,
            "vp_nav": vp_nav, "vp_mask": vp_mask, "step_valid": step_valid,
            "agg_w": agg_w, "gmap_step_ids": gmap_step,
            "gmap_pos_fts": gmap_pos, "gmap_mask": gmap_mask,
            "gmap_visited": gmap_visited, "gmap_pair": pair,
            "global_act_labels": np.int64(act_label),
            "vp_pos_fts": vp_pos,
            "last_step": np.int32(len(path) - 1),
        }
        aux = {"world": w, "path": path, "last_cands": step_cands[-1]}
        return sample, aux

    # ---- task batches ----

    def _mask_tokens(self, tokens: np.ndarray) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        return mask_tokens(self.rng, tokens, self.sh)

    def sample_batch(self, batch_size: int, task: str
                     ) -> Dict[str, np.ndarray]:
        sh = self.sh
        end_vp_type = "pos" if task in ("mrc", "og") else None
        samples, auxes = [], []
        for _ in range(batch_size):
            w, traj = self._sample_traj(end_vp_type)
            s, a = self._assemble(w, traj)
            samples.append(s)
            auxes.append(a)
        batch = {k: np.stack([s[k] for s in samples])
                 for k in samples[0].keys()}
        batch["txt_masks"] = batch["txt_ids"] != sh.pad_token_id
        if task == "mlm":
            masked, labels = zip(*[self._mask_tokens(s["txt_ids"])
                                   for s in samples])
            batch["txt_ids"] = np.stack(masked)
            batch["txt_labels"] = np.stack(labels)
        elif task == "mrc":
            self._apply_mrc(batch, samples, auxes)
        elif task == "og":
            if sh.num_objs <= 0:
                raise ValueError("og task requires PretrainShapes.num_objs"
                                 " > 0 (object annotations)")
            # labels index the local vp token axis ([stop] at 0)
            batch["obj_labels"] = np.asarray(
                [og_slot_label(sh, aux) for aux in auxes], np.int64)
        return batch

    def _apply_mrc(self, batch: Dict[str, np.ndarray], samples, auxes):
        """MRC masking (tasks.py:142-153,192-194): mask final-step view
        tokens with prob mrc_mask_prob (>=1), zero their image features,
        and attach per-token soft labels."""
        sh = self.sh
        B = len(samples)
        P = sh.tokens_per_step
        mrc_masks = np.zeros((B, P), bool)
        probs = np.zeros((B, P, sh.image_prob_size), np.float32)
        for i, (s, aux) in enumerate(zip(samples, auxes)):
            is_view, tok_probs = mrc_token_info(sh, s, aux)
            t = int(s["last_step"])
            pick = sample_mrc_mask(self.rng, is_view, sh.mrc_mask_prob)
            mrc_masks[i] = pick
            probs[i] = tok_probs
            batch["vp_img"][i, t][pick] = 0.0
        batch["vp_view_mrc_masks"] = mrc_masks
        batch["vp_view_probs"] = probs


def mrc_token_info(sh: PretrainShapes, sample: Dict[str, np.ndarray],
                   aux: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token MRC metadata for the final step: which tokens are camera
    views (maskable, tasks.py:192) and their (P, prob_size) soft labels
    (dataset.py:210). Cand slot k carries its candidate's view."""
    w = aux["world"]
    vp = aux["path"][-1]
    t = int(sample["last_step"])
    P = sh.tokens_per_step
    vprobs = w.view_probs(vp, sh.image_prob_size)
    tok_view = np.full(P, -1, np.int64)
    for k, cvp in enumerate(aux["last_cands"]):
        tok_view[k] = w.view_of_heading(w.heading_to(vp, cvp))
    for v in range(sh.num_views):
        slot = sh.max_cands + v
        if sample["vp_mask"][t, slot]:
            tok_view[slot] = v
    is_view = (tok_view >= 0) & sample["vp_mask"][t]
    probs = np.zeros((P, sh.image_prob_size), np.float32)
    probs[is_view] = vprobs[tok_view[is_view]]
    return is_view, probs


def sample_mrc_mask(rng: np.random.Generator, is_view: np.ndarray,
                    mask_prob: float) -> np.ndarray:
    """_get_img_mask (tasks.py:142-148): bernoulli over view tokens,
    at least one masked."""
    pick = (rng.random(len(is_view)) < mask_prob) & is_view
    if not pick.any():
        pick[int(rng.choice(np.flatnonzero(is_view)))] = True
    return pick


def og_slot_label(sh: PretrainShapes, aux: dict) -> int:
    """OG label = local vp-token slot of the target object at the final
    viewpoint ([stop] at 0)."""
    _, _, target = aux["world"].objects(aux["path"][-1], sh.num_objs)
    return 1 + sh.num_view_tokens + target


def _rel7(w: SyntheticNavWorld, cur: int, tgt: int,
          cur_heading: float) -> np.ndarray:
    """7-d relative position features of tgt seen from cur (the
    get_gmap_pos_fts layout, dataset.py:303-346): angle fts (4), euclidean
    / shortest distance / hops, normalized."""
    dvec = w.pos[tgt] - w.pos[cur]
    xz = max(np.hypot(dvec[0], dvec[2]), 1e-8)
    heading = np.arcsin(-dvec[0] / xz)
    if dvec[2] > 0:
        heading = np.pi - heading
    heading -= cur_heading
    out = np.zeros(7, np.float32)
    out[:4] = angle_features(np.array([heading]), np.array([0.0]))[0]
    out[4] = np.linalg.norm(dvec) / MAX_DIST
    out[5] = w.dist[cur, tgt] / MAX_DIST
    out[6] = (w.hops[cur, tgt] + 1) / MAX_STEP
    return out


def mask_tokens(rng: np.random.Generator, tokens: np.ndarray,
                sh: PretrainShapes) -> Tuple[np.ndarray, np.ndarray]:
    """BERT 15% / 80-10-10 masking (tasks.py:12-52); labels -1 ignore."""
    out = tokens.copy()
    labels = np.full_like(tokens, -1)
    real = tokens != sh.pad_token_id
    r = rng.random(tokens.shape)
    pick = (r < 0.15) & real
    if not pick.any():
        idx = int(np.flatnonzero(real)[0])
        pick[idx] = True
        r[idx] = 0.0
    sub = r / 0.15
    labels[pick] = tokens[pick]
    out[pick & (sub < 0.8)] = sh.mask_token_id
    rand_pos = pick & (sub >= 0.8) & (sub < 0.9)
    out[rand_pos] = rng.integers(
        sh.mask_vocab_range[0], sh.mask_vocab_range[1],
        int(rand_pos.sum()))
    return out, labels


class MetaSampler:
    """MetaLoader-style multinomial task mixing (loader.py:18-88). All
    hosts share the rng seed, so every process picks the same task per step
    (in place of the dist.broadcast at loader.py:56-59).
    """

    def __init__(self, sampler: PretrainSampler, batch_size: int,
                 ratios=(1.0, 1.0), seed: int = 0,
                 tasks=("mlm", "sap")):
        self.sampler = sampler
        self.batch_size = batch_size
        self.tasks = list(tasks)
        p = np.asarray(ratios, np.float64)
        self.p = p / p.sum()
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Tuple[str, Dict[str, np.ndarray]]]:
        while True:
            task = self.tasks[self.rng.choice(len(self.tasks), p=self.p)]
            yield task, self.sampler.sample_batch(self.batch_size, task)
