"""Real-data pretraining source: MP3D annotation files + precomputed
HDF5 features + connectivity graphs (the port's own copy of
`etpnav_tpu/data/mp3d_pretrain.py`: the same draws in the same order, so
a batch equals the JAX package's).

Capability target: R2RTextPathData (pretrain_src data/dataset.py:360-525)
— anno json/jsonl trajectories over MP3D scans, HDF5 CLIP/depth feature
stores, connectivity-graph APSP — emitting the SAME fixed-shape batch
layout as the synthetic PretrainSampler so training/pretrain.py is
data-source agnostic.

Everything is file-gated: instantiate only when the reference's data
artifacts are present (anno files, img/dep HDF5, connectivity dir).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from etpnav_tpu_torch.data.feature_pipeline import HDF5FeatureStore, \
    load_connectivity
from etpnav_tpu_torch.data.pretrain_data import (
    PretrainShapes,
    mask_tokens,
    sample_mrc_mask,
)
from etpnav_tpu_torch.graph.geometry import angle_features

MAX_DIST = 30.0
MAX_STEP = 10.0


class ScanGraph:
    """Connectivity graph of one scan with APSP (data/common.py:71)."""

    def __init__(self, connectivity_dir: str, scan: str):
        conn = load_connectivity(connectivity_dir, scan)
        self.vp_ids = sorted(conn)
        self.index = {vp: i for i, vp in enumerate(self.vp_ids)}
        n = len(self.vp_ids)
        self.pos = np.stack([conn[vp]["position"] for vp in self.vp_ids])
        dist = np.full((n, n), 1e9)
        np.fill_diagonal(dist, 0.0)
        self.adj: List[List[int]] = [[] for _ in range(n)]
        for i, vp in enumerate(self.vp_ids):
            # neighbors are image_ids resolved from the raw-file-order
            # unobstructed indices by load_connectivity — indexing the
            # raw booleans into these sorted/filtered ids would scramble
            # the graph (common.py:87-94 semantics)
            for nb in conn[vp]["neighbors"]:
                j = self.index[nb]
                d = float(np.linalg.norm(self.pos[i] - self.pos[j]))
                dist[i, j] = min(dist[i, j], d)
                self.adj[i].append(j)
        hops = np.where(dist < 1e8, 1, 10**6).astype(np.int64)
        np.fill_diagonal(hops, 0)
        for k in range(n):
            via = dist[:, k][:, None] + dist[k, :][None, :]
            hvia = hops[:, k][:, None] + hops[k, :][None, :]
            better = via < dist
            dist = np.where(better, via, dist)
            hops = np.where(better, hvia, hops)
        self.dist, self.hops = dist, hops


def load_annotations(anno_files: List[str], max_txt_len: int
                     ) -> List[dict]:
    """R2R-style pretraining annotations: items with scan, path (vp ids),
    heading, instr_encoding (dataset.py:408-420)."""
    out = []
    for path in anno_files:
        with open(path) as f:
            data = json.load(f)
        for item in data:
            out.append({
                "scan": item["scan"],
                "path": item["path"],
                "heading": item.get("heading", 0.0),
                "instr_encoding": np.asarray(
                    item["instr_encoding"][:max_txt_len], np.int64),
                "instr_id": item.get("instr_id", ""),
            })
    return out


def _softmax_rows(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _rel7_graph(g: "ScanGraph", cur: int, tgt: int,
                cur_heading: float) -> np.ndarray:
    """7-d relative position features of tgt seen from cur over the
    connectivity graph (get_gmap_pos_fts layout, dataset.py:303-346):
    angle fts (4), euclidean / shortest distance / hops, normalized."""
    d = g.pos[tgt] - g.pos[cur]
    xz = max(np.hypot(d[0], d[2]), 1e-8)
    heading = np.arcsin(-d[0] / xz)
    if d[2] > 0:
        heading = np.pi - heading
    heading -= cur_heading
    out = np.zeros(7, np.float32)
    out[:4] = angle_features(np.array([heading]), np.array([0.0]))[0]
    out[4] = np.linalg.norm(d) / MAX_DIST
    out[5] = g.dist[cur, tgt] / MAX_DIST
    out[6] = (g.hops[cur, tgt] + 1) / MAX_STEP
    return out


class MP3DTrajectoryData:
    """Drop-in replacement for PretrainSampler backed by real artifacts."""

    def __init__(self, shapes: PretrainShapes, anno_files: List[str],
                 img_ft_file: str, dep_ft_file: str,
                 connectivity_dir: str, seed: int = 0):
        self.sh = shapes
        self.rng = np.random.default_rng(seed)
        self.data = load_annotations(anno_files, shapes.max_txt_len)
        self.img_store = HDF5FeatureStore(img_ft_file)
        self.dep_store = HDF5FeatureStore(dep_ft_file)
        self.connectivity_dir = connectivity_dir
        self._graphs: Dict[str, ScanGraph] = {}
        self._img_width: Optional[int] = None

    def _probe_img_width(self) -> int:
        """Column count of the image store rows: image_feat_size for the
        released CLIP stores, image_feat_size + image_prob_size for
        prob-augmented stores emitted by data/feature_pipeline.py with a
        class projection (the dataset.py:210 layout)."""
        if self._img_width is None:
            item = self.data[0]
            arr = self.img_store.get(item["scan"], item["path"][0])
            self._img_width = int(arr.shape[-1])
        return self._img_width

    def graph(self, scan: str) -> ScanGraph:
        if scan not in self._graphs:
            self._graphs[scan] = ScanGraph(self.connectivity_dir, scan)
        return self._graphs[scan]

    # ---- sample assembly (mirrors PretrainSampler._assemble over real
    #      features; dataset.py:483-525 / :288-340) ----

    def _view_of(self, g: ScanGraph, u: int, v: int) -> Tuple[int, float]:
        d = g.pos[v] - g.pos[u]
        heading = math.atan2(-d[0], -d[2]) % (2 * math.pi)
        sector = 2 * math.pi / self.sh.num_views
        return int(round(heading / sector)) % self.sh.num_views, heading

    def sample_batch(self, batch_size: int, task: str
                     ) -> Dict[str, np.ndarray]:
        sh = self.sh
        if task == "og":
            # object annotations are absent from the MP3D R2R artifacts
            # (REVERIE-only); OG stays synthetic-source-only
            raise NotImplementedError(
                "og needs object annotations not present in the MP3D "
                "R2R artifacts; use the synthetic PretrainSampler")
        if task == "mrc":
            prob_cols = self._probe_img_width() - sh.image_feat_size
            if prob_cols < sh.image_prob_size or sh.image_prob_size <= 0:
                # The released R2R store has exactly image_feat_size CLIP
                # columns — no logit columns, so dataset.py:210's soft
                # labels would be empty. feature_pipeline.FeatureExtractor
                # (class_proj=...) of the JAX package emits a
                # prob-augmented store.
                raise NotImplementedError(
                    f"mrc needs {sh.image_prob_size} CLIP-logit columns "
                    f"after the {sh.image_feat_size} feature columns; "
                    f"this store has {max(prob_cols, 0)} — re-extract "
                    "with etpnav_tpu/data/feature_pipeline.py class_proj")
        samples = [self._one(task) for _ in range(batch_size)]
        auxes = [s.pop("_aux") for s in samples]
        batch = {k: np.stack([s[k] for s in samples])
                 for k in samples[0].keys()}
        batch["txt_masks"] = batch["txt_ids"] != sh.pad_token_id
        if task == "mlm":
            masked, labels = zip(*[mask_tokens(self.rng, s["txt_ids"],
                                               self.sh) for s in samples])
            batch["txt_ids"] = np.stack(masked)
            batch["txt_labels"] = np.stack(labels)
        elif task == "mrc":
            # MRC masking over the final step's view tokens with soft
            # CLIP-prob labels (tasks.py:142-153,192-194; dataset.py:210)
            B, P = len(samples), sh.tokens_per_step
            mrc_masks = np.zeros((B, P), bool)
            probs = np.zeros((B, P, sh.image_prob_size), np.float32)
            for i, (s, aux) in enumerate(zip(samples, auxes)):
                t = int(s["last_step"])
                tok_view = aux["tok_view"]                  # (P,) or -1
                is_view = (tok_view >= 0) & s["vp_mask"][t]
                logits = aux["img_row"][:, sh.image_feat_size:
                                        sh.image_feat_size
                                        + sh.image_prob_size]
                vprobs = _softmax_rows(logits)              # (V, prob)
                probs[i][is_view] = vprobs[tok_view[is_view]]
                pick = sample_mrc_mask(self.rng, is_view,
                                       sh.mrc_mask_prob)
                mrc_masks[i] = pick
                batch["vp_img"][i, t][pick] = 0.0
            batch["vp_view_mrc_masks"] = mrc_masks
            batch["vp_view_probs"] = probs
        return batch

    def _one(self, task: str) -> Dict[str, np.ndarray]:
        sh = self.sh
        item = self.data[self.rng.integers(len(self.data))]
        g = self.graph(item["scan"])
        full_path = [g.index[vp] for vp in item["path"]]

        r = self.rng.random()
        if task in ("mlm", "mrc") or r < 0.2 or len(full_path) <= 1:
            # mrc uses the positive end viewpoint (MrcDataset
            # end_vp_pos_ratio=1, tasks.py:162-183)
            path = full_path
            end_is_goal = True
            gt_next = None
        else:
            end_idx = int(self.rng.integers(len(full_path) - 1))
            path = full_path[:end_idx + 1]
            end_is_goal = False
            gt_next = full_path[end_idx + 1]
        if len(path) > sh.max_traj_steps:
            # truncation moves the endpoint: the next-step supervision is
            # the node right after the cut (NOT the pre-cut gt_next, which
            # is unrelated to the truncated endpoint), and the truncated
            # end is no longer the goal
            path = path[:sh.max_traj_steps]
            end_is_goal = False
            gt_next = full_path[sh.max_traj_steps]
        if gt_next in path:
            gt_next = None

        T, P, G = sh.max_traj_steps, sh.tokens_per_step, sh.max_gmap_len
        out = {
            "vp_img": np.zeros((T, P, sh.image_feat_size), np.float32),
            "vp_dep": np.zeros((T, P, sh.depth_feat_size), np.float32),
            "vp_loc": np.zeros((T, P, 4), np.float32),
            "vp_nav": np.zeros((T, P), np.int32),
            "vp_mask": np.zeros((T, P), bool),
            "step_valid": np.zeros((T,), bool),
            "agg_w": np.zeros((G, T * P), np.float32),
            "gmap_step_ids": np.zeros((G,), np.int32),
            "gmap_pos_fts": np.zeros((G, 7), np.float32),
            "gmap_mask": np.zeros((G,), bool),
            "gmap_visited": np.zeros((G,), bool),
            "gmap_pair": np.zeros((G, G), np.float32),
        }
        visited: Dict[int, int] = {}
        unvisited: Dict[int, List[Tuple[int, int]]] = {}
        for t, vi in enumerate(path):
            vp = g.vp_ids[vi]
            img = self.img_store.get(item["scan"], vp)
            dep = self.dep_store.get(item["scan"], vp)
            cands = g.adj[vi][:sh.max_cands]
            used = set()
            for k, ci in enumerate(cands):
                view, heading = self._view_of(g, vi, ci)
                used.add(view)
                out["vp_img"][t, k] = img[view][:sh.image_feat_size]
                out["vp_dep"][t, k] = dep[view][:sh.depth_feat_size]
                out["vp_loc"][t, k] = angle_features(
                    np.array([heading]), np.array([0.0]))[0]
                out["vp_nav"][t, k] = 1
                out["vp_mask"][t, k] = True
            for v in range(sh.num_views):
                if v in used:
                    continue
                slot = sh.max_cands + v
                out["vp_img"][t, slot] = img[v][:sh.image_feat_size]
                out["vp_dep"][t, slot] = dep[v][:sh.depth_feat_size]
                hv = v * 2 * math.pi / sh.num_views
                out["vp_loc"][t, slot] = angle_features(
                    np.array([hv]), np.array([0.0]))[0]
                out["vp_mask"][t, slot] = True
            out["step_valid"][t] = True
            visited[vi] = t + 1
            unvisited.pop(vi, None)
            for k, ci in enumerate(cands):
                if ci not in visited:
                    unvisited.setdefault(ci, []).append((t, k))

        slots = ([("stop", -1)] + [("node", v) for v in visited]
                 + [("ghost", v) for v in unvisited])[:G]
        cur = path[-1]
        cur_heading = self._view_of(g, path[-2], path[-1])[1] \
            if len(path) > 1 else float(item["heading"])
        slot_vps: List[Optional[int]] = []
        for si, (kind, vi) in enumerate(slots):
            out["gmap_mask"][si] = True
            if kind == "stop":
                out["gmap_pos_fts"][si, :4] = angle_features(
                    np.zeros(1), np.zeros(1))[0]
                slot_vps.append(None)
                continue
            slot_vps.append(vi)
            if kind == "node":
                t = visited[vi] - 1
                out["gmap_step_ids"][si] = visited[vi]
                out["gmap_visited"][si] = True
                valid = out["vp_mask"][t]
                out["agg_w"][si, t * P:(t + 1) * P][valid] = \
                    1.0 / valid.sum()
            else:
                for (t, k) in unvisited[vi]:
                    out["agg_w"][si, t * P + k] += 1.0 / len(unvisited[vi])
            out["gmap_pos_fts"][si] = _rel7_graph(g, cur, vi, cur_heading)
        vp_arr = np.asarray(slot_vps[1:], np.int64)
        if len(vp_arr):
            block = g.dist[np.ix_(vp_arr, vp_arr)] / MAX_DIST
            np.fill_diagonal(block, 0.0)
            out["gmap_pair"][1:len(slots), 1:len(slots)] = block

        out["txt_ids"] = np.full(sh.max_txt_len, sh.pad_token_id, np.int64)
        enc = item["instr_encoding"]
        out["txt_ids"][:len(enc)] = enc

        # final-step local-branch inputs + MRC metadata (same layout as
        # the synthetic sampler: vp_pos_fts rows carry start-rel [:7] on
        # every row, cand-rel [7:] on cand rows; dataset.py:288-340)
        t_last = len(path) - 1
        out["last_step"] = np.int32(t_last)
        vp_pos = np.zeros((1 + P, 14), np.float32)
        vp_pos[:, :7] = _rel7_graph(g, cur, path[0], cur_heading)
        last_cands = g.adj[cur][:sh.max_cands]
        tok_view = np.full(P, -1, np.int64)
        for k, ci in enumerate(last_cands):
            vp_pos[1 + k, 7:] = _rel7_graph(g, cur, ci, cur_heading)
            tok_view[k] = self._view_of(g, cur, ci)[0]
        for v in range(sh.num_views):
            slot = sh.max_cands + v
            if out["vp_mask"][t_last, slot]:
                tok_view[slot] = v
        out["vp_pos_fts"] = vp_pos
        out["_aux"] = {
            "tok_view": tok_view,
            "img_row": self.img_store.get(item["scan"], g.vp_ids[cur]),
        }
        if end_is_goal:
            label = 0
        else:
            label = -100
            if gt_next is not None:
                for si, vi in enumerate(slot_vps):
                    if vi == gt_next and not out["gmap_visited"][si]:
                        label = si
                        break
        out["global_act_labels"] = np.int64(label)
        return out


# ---------------------------------------------------------------------------
# store-validation CLI (real-artifact drill)
# ---------------------------------------------------------------------------

def check_store(anno_files: List[str], img_ft_file: str, dep_ft_file: str,
                connectivity_dir: str, *, shapes: PretrainShapes = None,
                sample: bool = True, print_fn=print) -> dict:
    """Validate a real MP3D pretraining store's schema and report what it
    would train on — the one-command drill for the environment-blocked
    real-data gate (reference artifacts: pretrain_src data/dataset.py
    anno jsons + img_features/dep_features HDF5 + connectivity/).

    Checks, erroring with actionable messages:
    - every annotation references a scan with a connectivity file and
      viewpoints present in that graph;
    - every path viewpoint has an HDF5 row in both stores under the
      '{scan}_{vp}' key layout;
    - feature widths match (512 CLIP / 512+prob-augmented, 128 depth);
    - draws one sample batch per supported task when sample=True.
    Returns a summary dict (also printed as one JSON line).
    """
    import collections

    import h5py

    data = load_annotations(anno_files, max_txt_len=200)
    if not data:
        raise ValueError(f"no annotations found in {anno_files}")
    by_scan = collections.Counter(it["scan"] for it in data)
    summary = {"annotations": len(data), "scans": len(by_scan),
               "anno_files": list(anno_files)}

    graphs = {}
    for scan in by_scan:
        try:
            graphs[scan] = ScanGraph(connectivity_dir, scan)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"scan {scan!r} referenced by annotations has no "
                f"connectivity file under {connectivity_dir!r}") from e
    summary["viewpoints"] = sum(len(g.vp_ids) for g in graphs.values())

    widths = {}
    for name, path in (("img", img_ft_file), ("dep", dep_ft_file)):
        with h5py.File(path, "r") as f:
            keys = set(f.keys())
            missing = []
            for it in data:
                for vp in it["path"]:
                    if f"{it['scan']}_{vp}" not in keys:
                        missing.append(f"{it['scan']}_{vp}")
            if missing:
                raise KeyError(
                    f"{name} store {path!r} is missing {len(missing)} "
                    f"'{{scan}}_{{vp}}' rows referenced by annotations, "
                    f"e.g. {missing[:5]}")
            first = f[f"{data[0]['scan']}_{data[0]['path'][0]}"]
            widths[name] = (int(first.shape[0]), int(first.shape[-1]))
    summary["img_store"] = {"views": widths["img"][0],
                            "cols": widths["img"][1]}
    summary["dep_store"] = {"views": widths["dep"][0],
                            "cols": widths["dep"][1]}

    if shapes is None:
        img_cols = widths["img"][1]
        shapes = PretrainShapes(
            max_txt_len=80, max_traj_steps=10,
            num_views=widths["img"][0], max_cands=10, max_gmap_len=64,
            image_feat_size=min(img_cols, 512),
            depth_feat_size=widths["dep"][1],
            vocab_size=30522, mask_token_id=103,
            mask_vocab_range=(1000, 29000),
            image_prob_size=max(img_cols - 512, 0))
    prob_augmented = widths["img"][1] > shapes.image_feat_size
    summary["mrc_capable"] = bool(prob_augmented)
    tasks = ["mlm", "sap"] + (["mrc"] if prob_augmented else [])
    summary["tasks"] = tasks

    if sample:
        src = MP3DTrajectoryData(shapes, anno_files, img_ft_file,
                                 dep_ft_file, connectivity_dir, seed=0)
        shapes_out = {}
        for task in tasks:
            b = src.sample_batch(2, task)
            shapes_out[task] = {k: list(v.shape) for k, v in b.items()
                                if hasattr(v, "shape")}
        summary["sample_batch_shapes"] = shapes_out
    print_fn(json.dumps(summary))
    return summary


def main(args=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Validate a real MP3D pretraining store (drill for "
                    "the blocked real-data gate)")
    ap.add_argument("--anno", nargs="+", required=True)
    ap.add_argument("--img-store", required=True)
    ap.add_argument("--dep-store", required=True)
    ap.add_argument("--connectivity", required=True)
    ap.add_argument("--no-sample", action="store_true")
    ns = ap.parse_args(args)
    check_store(ns.anno, ns.img_store, ns.dep_store, ns.connectivity,
                sample=not ns.no_sample)


if __name__ == "__main__":
    main()
