"""Readers of the offline feature artifacts: MP3D connectivity graphs and
the precomputed HDF5 feature stores (the port's own copy of
`load_connectivity` and `HDF5FeatureStore` from
`etpnav_tpu/data/feature_pipeline.py`, numpy and h5py only; h5py is
imported by the functions that open a file).

The feature extractor of that module (rendered panoramas -> CLIP / depth
features -> HDF5) is not ported; the stores it writes, and the
reference's released ones, read here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


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
