"""Offline panorama feature extraction and its stores (the port's
counterpart of `etpnav_tpu/data/feature_pipeline.py`): rendered poses ->
batched CLIP / depth encoding on the device -> HDF5 feature store, and the
readers of those stores and of MP3D connectivity graphs.

Capability target: precompute_img_features/ (SURVEY.md §2 row 34) —
save_img.py's MatterSim pose walk, extract_rgb_features.py's CLIP
extraction (optionally with zero-shot class logits) and
extract_depth_features.py — as one process with one device batch per
chunk of viewpoints and a single h5py writer. The pose walk runs over
connectivity JSONs (no MatterSim). h5py is imported by the functions that
open a file.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

DISCRETE_VIEWS_36 = [(math.radians(h), math.radians(e))
                     for e in (-30, 0, 30) for h in range(0, 360, 30)]
DISCRETE_VIEWS_12 = [(math.radians(h), 0.0) for h in range(0, 360, 30)]


def load_connectivity(connectivity_dir: str, scan: str) -> Dict[str, dict]:
    """MP3D connectivity JSON -> viewpoint_id -> {position, neighbors...}
    (the pose source save_img.py walks via MatterSim).

    The JSON's ``unobstructed`` booleans index the RAW FILE ORDER of the
    scan's entries — including excluded ones (reference
    pretrain_src/data/common.py:87-94 indexes ``data[j]``). Because this
    loader drops excluded entries (and callers may re-sort keys), raw
    indices are resolved to image_ids here: ``neighbors`` lists the
    included image_ids reachable from each viewpoint. The raw
    ``unobstructed`` list is kept verbatim for completeness; never index
    it into a filtered/sorted id list."""
    path = os.path.join(connectivity_dir, f"{scan}_connectivity.json")
    with open(path) as f:
        data = json.load(f)
    raw_ids = [e["image_id"] for e in data]
    included = {e["image_id"] for e in data if e.get("included", True)}
    out = {}
    for entry in data:
        if entry["image_id"] not in included:
            continue
        unob = entry.get("unobstructed", [])
        neighbors = [raw_ids[j] for j, ok in enumerate(unob)
                     if ok and j < len(raw_ids)
                     and raw_ids[j] in included
                     and raw_ids[j] != entry["image_id"]]
        # 4x4 row-major habitat-style pose matrix; translation in col 3
        m = np.asarray(entry["pose"], np.float64).reshape(4, 4)
        out[entry["image_id"]] = {
            "position": m[:3, 3],
            "neighbors": neighbors,
            "unobstructed": unob,
            "height": entry.get("height", 1.5),
        }
    return out


def pose_walk(connectivity_dir: str, scan: str,
              num_views: int = 36) -> Iterable[Tuple[str, List[Tuple]]]:
    """Yield (viewpoint_id, [(heading, elevation), ...]) pose tuples for
    every included viewpoint, in sorted id order (save_img.py:25-80
    without MatterSim)."""
    views = DISCRETE_VIEWS_36 if num_views == 36 else DISCRETE_VIEWS_12
    conn = load_connectivity(connectivity_dir, scan)
    for vp_id in sorted(conn):
        yield vp_id, views


class FeatureExtractor:
    """Batched feature extraction over rendered panoramas, on the GPU
    unless `device="cpu"` is passed.

    One call encodes B panoramas of V views: the CLIP tower over the
    normalised float images (`clip_vit.encode_image(preprocess_rgb(rgb))`,
    not the uint8 fold of the agent's perceive), then the depth trunk
    (`encode_depth`) and the spatial mean of its map, both in `dtype`
    (bf16 by default, as the JAX package's). With `cfg.clip.use_fused_block`
    and `cfg.depth.use_fused_gn` the towers run K-PRENORM and K-GN, as
    perceive does.

    class_proj: optional (num_classes, clip_output_dim) class text-
    embedding matrix, normalised per row in numpy fp32. When given, the
    zero-shot class logits 100 * norm(img) @ norm(class).T (the CLIP
    logit convention) follow the feature columns: the prob-augmented
    store layout that MRC pretraining reads (pretrain_src
    data/dataset.py:210 soft labels = softmax(row[image_feat_size:]))."""

    def __init__(self, cfg, agent_params, batch_panos: int = 8,
                 class_proj=None, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        from etpnav_tpu_torch.device import resolve_device
        self.cfg = cfg
        self.device = resolve_device(device)
        self.clip = agent_params.clip.to(self.device)
        self.depth = agent_params.depth.to(self.device)
        self.batch_panos = batch_panos
        self.dtype = dtype
        self.num_classes = 0 if class_proj is None else class_proj.shape[0]
        self.class_proj = None
        if class_proj is not None:
            class_proj = np.asarray(class_proj, np.float32)
            class_proj = class_proj / np.linalg.norm(
                class_proj, axis=-1, keepdims=True)
            self.class_proj = torch.from_numpy(class_proj).to(self.device)

    @torch.inference_mode()
    def encode(self, rgb: torch.Tensor, depth: torch.Tensor):
        """rgb (B, V, H, W, 3) uint8, depth (B, V, h, w, 1) on the device
        -> (B, V, img_ft [+ classes]), (B, V, dep_ft) fp32 tensors."""
        from etpnav_tpu_torch.models import clip_vit, depth_resnet
        B, V = rgb.shape[:2]
        rgb_f = clip_vit.encode_image(
            self.clip, self.cfg.clip,
            clip_vit.preprocess_rgb(rgb.reshape((B * V,) + rgb.shape[2:])),
            self.dtype)
        if self.class_proj is not None:
            normed = rgb_f / torch.linalg.norm(rgb_f, dim=-1, keepdim=True)
            logits = 100.0 * normed @ self.class_proj.T
            rgb_f = torch.cat([rgb_f, logits], dim=-1)
        dep_sp = depth_resnet.encode_depth(
            self.depth, self.cfg.depth,
            depth.reshape((B * V,) + depth.shape[2:]), self.dtype)
        s, c = dep_sp.shape[1], dep_sp.shape[-1]
        dep_f = dep_sp.reshape(B * V, s * s, c).mean(1)
        return rgb_f.reshape(B, V, -1), dep_f.reshape(B, V, -1)

    def __call__(self, rgb: np.ndarray, depth: np.ndarray):
        """rgb (B, V, H, W, 3) uint8, depth (B, V, h, w, 1) -> numpy
        (B, V, img_ft), (B, V, dep_ft)."""
        r, d = self.encode(torch.from_numpy(np.asarray(rgb)).to(self.device),
                           torch.from_numpy(np.asarray(depth, np.float32))
                           .to(self.device))
        return r.cpu().numpy(), d.cpu().numpy()


def extract_scan_features(scan: str, render_fn: Callable,
                          extractor: FeatureExtractor,
                          img_out: str, dep_out: str,
                          connectivity_dir: Optional[str] = None,
                          viewpoints: Optional[List[str]] = None,
                          num_views: int = 12):
    """Render + encode + write one scan's viewpoints.

    render_fn(scan, vp_id, views) -> (rgb (V,H,W,3) uint8,
    depth (V,h,w,1) float). Output layout matches the reference HDF5
    stores: key '{scan}_{vp}' -> (V, feat) float32
    (extract_rgb_features.py:111-129). The last chunk is padded to the
    extractor's batch by repeating its last panorama, so every batch has
    one shape.
    """
    import h5py

    if viewpoints is None:
        if connectivity_dir is None:
            raise ValueError("pass viewpoints or connectivity_dir")
        viewpoints = [vp for vp, _ in pose_walk(connectivity_dir, scan,
                                                num_views)]
    views = DISCRETE_VIEWS_36 if num_views == 36 else DISCRETE_VIEWS_12

    with h5py.File(img_out, "a") as f_img, h5py.File(dep_out, "a") as f_dep:
        bp = extractor.batch_panos
        for i in range(0, len(viewpoints), bp):
            chunk = viewpoints[i:i + bp]
            rgb = []
            dep = []
            for vp in chunk:
                r, d = render_fn(scan, vp, views)
                rgb.append(r)
                dep.append(d)
            while len(rgb) < bp:
                rgb.append(rgb[-1])
                dep.append(dep[-1])
            rgb_f, dep_f = extractor(np.stack(rgb), np.stack(dep))
            for j, vp in enumerate(chunk):
                key = f"{scan}_{vp}"
                for f, data in ((f_img, rgb_f[j]), (f_dep, dep_f[j])):
                    if key in f:
                        del f[key]
                    f.create_dataset(key, data=data.astype(np.float32))


class HDF5FeatureStore:
    """Reader for the reference's precomputed feature HDF5 layout
    (pretrain dataset.py:375-388: key '{scan}_{vp}' -> (views, feat)),
    with in-memory caching."""

    def __init__(self, path: str, in_memory: bool = True):
        self.path = path
        self.in_memory = in_memory
        self._cache: Dict[str, np.ndarray] = {}
        self._file = None

    def _f(self):
        import h5py
        if self._file is None:
            self._file = h5py.File(self.path, "r")
        return self._file

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        key = f"{scan}_{viewpoint}"
        if key in self._cache:
            return self._cache[key]
        arr = self._f()[key][...].astype(np.float32)
        if self.in_memory:
            self._cache[key] = arr
        return arr

    def keys(self) -> List[str]:
        return list(self._f().keys())

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
