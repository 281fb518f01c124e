"""Shared trajectory / camera-rig utilities (the port's own copy of
`etpnav_tpu/utils/trajectory.py`).

Capability target: vlnce_baselines/common/utils.py — discrete-to-continuous
path densification (dis_to_con, :45-61) and the 12-camera rig builder
(get_camera_orientations12, :62-67).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def densify_path(path: np.ndarray, amount: float = 0.25) -> np.ndarray:
    """Discrete waypoint path -> continuous micro-step path with points
    every `amount` meters along each segment (dis_to_con semantics)."""
    path = np.asarray(path, np.float64)
    if len(path) < 2:
        return path.copy()
    out = [path[0]]
    for a, b in zip(path, path[1:]):
        seg = b - a
        dist = float(np.linalg.norm(seg))
        n = int(dist // amount)
        for k in range(1, n + 1):
            out.append(a + seg * (k * amount / dist))
        if not np.allclose(out[-1], b):
            out.append(b)
    return np.stack(out)


def camera_orientations_12() -> Dict[str, List[float]]:
    """12 yaw orientations (rad) for the panorama camera rig, keyed like
    the reference's sensor-uuid suffixes ('' for forward, '_1'..'_11'
    counter-clockwise)."""
    return {("" if i == 0 else f"_{i}"): [0.0, 2.0 * np.pi * i / 12.0, 0.0]
            for i in range(12)}


def ndtw_subgoal_index(within: np.ndarray, progress: int):
    """Subgoal selection for the ndtw expert, replicating
    environments.py:163-180 EXACTLY — including the reference's
    run-relative indexing quirk: when the candidate indices are
    non-contiguous (e.g. cand=[5,6,9]), the reference computes
    `np.where(compare==False)[0][0]-1`, a POSITION within cand minus
    one, and indexes ref_path with it (ref[1] here, not ref[6]). The
    released checkpoints were trained with this behavior, so parity
    preserves it rather than "fixing" it.

    within: bool array, ref points within 3 m of the agent.
    Returns (sub_idx, new_progress); sub_idx None means "keep the
    previous subgoal position" (no ref point within 3 m)."""
    if not within.any():
        return None, progress
    cand = np.flatnonzero(within & (np.arange(len(within)) >= progress))
    if len(cand) == 0:
        return int(progress), progress
    run = np.arange(cand[0], cand[0] + len(cand))
    mism = np.flatnonzero(run != cand)
    if len(mism) == 0:
        sub_idx = int(cand[-1])
    else:
        sub_idx = int(mism[0] - 1)      # the quirk: position, not index
    return sub_idx, sub_idx


def unique_consecutive(points: List) -> List:
    """Drop consecutive duplicate positions (submission-path compaction,
    ss_trainer_ETP.py:748-751)."""
    out = []
    for p in points:
        if not out or list(p) != list(out[-1]):
            out.append(p)
    return out
