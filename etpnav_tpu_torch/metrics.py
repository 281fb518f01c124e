"""Navigation metrics computed client-side from raw trajectories (the
port's own copy of `etpnav_tpu/metrics.py`).

Capability target: the eval-metric block of the reference trainer
(ss_trainer_ETP.py:983-1006) and the NDTW/SDTW measures
(habitat_extensions/measures.py:266-372). DTW is implemented here directly
(windowed dynamic programming) instead of depending on fastdtw; for the
trajectory lengths involved (<=500 points) the exact O(N*M) DP is fast and
deterministic.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SUCCESS_DISTANCE = 3.0


def dtw(a: np.ndarray, b: np.ndarray) -> float:
    """Exact DTW with Euclidean point distance. Uses the native C++ core
    when available (native/topo_core.cpp)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2 and a.shape[1] == 3 and b.ndim == 2 and b.shape[1] == 3:
        from etpnav_tpu_torch import native
        res = native.dtw(a, b)
        if res is not None:
            return res
    n, m = len(a), len(b)
    # pairwise distances (N, M), vectorized
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        trans = np.minimum(acc[i - 1, 1:], acc[i - 1, :-1])
        row = acc[i]
        for j in range(1, m + 1):
            row[j] = d[i - 1, j - 1] + min(trans[j - 1], row[j - 1])
    return float(acc[n, m])


def ndtw(pred_path: np.ndarray, gt_path: np.ndarray,
         success_distance: float = SUCCESS_DISTANCE) -> float:
    """exp(-DTW / (|gt| * d_success)) (measures.py:330-333)."""
    return float(np.exp(-dtw(pred_path, gt_path)
                        / (len(gt_path) * success_distance)))


def path_length(path: np.ndarray) -> float:
    path = np.asarray(path)
    if len(path) < 2:
        return 0.0
    return float(np.linalg.norm(path[1:] - path[:-1], axis=1).sum())


def episode_metrics(pred_path: np.ndarray, dist_to_goal: np.ndarray,
                    gt_path: np.ndarray, steps_taken: int,
                    collision_count: int,
                    success_distance: float = SUCCESS_DISTANCE
                    ) -> Dict[str, float]:
    """Per-episode metric dict mirroring ss_trainer_ETP.py:993-1005."""
    pred_path = np.asarray(pred_path)
    dist_to_goal = np.asarray(dist_to_goal)
    m: Dict[str, float] = {}
    m["steps_taken"] = float(steps_taken)
    m["distance_to_goal"] = float(dist_to_goal[-1])
    m["success"] = 1.0 if dist_to_goal[-1] <= success_distance else 0.0
    m["oracle_success"] = 1.0 if (dist_to_goal
                                  <= success_distance).any() else 0.0
    m["path_length"] = path_length(pred_path)
    m["collisions"] = collision_count / max(len(pred_path), 1)
    gt_length = float(dist_to_goal[0])
    m["spl"] = m["success"] * gt_length / max(gt_length, m["path_length"]) \
        if max(gt_length, m["path_length"]) > 0 else 0.0
    m["ndtw"] = ndtw(pred_path, gt_path, success_distance)
    m["sdtw"] = m["ndtw"] * m["success"]
    return m


def aggregate(stats: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Mean over episodes (ss_trainer_ETP.py:601-606)."""
    if not stats:
        return {}
    keys = next(iter(stats.values())).keys()
    n = len(stats)
    return {k: sum(s[k] for s in stats.values()) / n for k in keys}
