"""Eval videos: top-down topological-map rendering, panorama frame
composition and video writing (counterpart of
`etpnav_tpu/utils/visualization.py`, whose numpy/cv2 code this copies).

Capability target: habitat_extensions/utils.py:647-752
(navigator_video_frame / planner_video_frame / generate_video) and the
maps.py draw helpers (:68-275) — reimplemented over plain numpy/cv2
without habitat's TopDownMap machinery: the geometric world (or any
trajectory + graph) is rasterized directly from world coordinates. cv2
is imported by the functions that draw, never at module import.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

AGENT_COLOR = (40, 80, 240)
NODE_COLOR = (60, 180, 75)
GHOST_COLOR = (170, 110, 40)
GT_COLOR = (200, 200, 60)
PATH_COLOR = (240, 120, 40)
GOAL_COLOR = (50, 50, 220)
EDGE_COLOR = (190, 190, 190)


class TopDownRenderer:
    """World-coordinate rasterizer for trajectories and topo maps."""

    def __init__(self, size: int = 512, extent: float = 12.0):
        self.size = size
        self.extent = extent

    def _to_px(self, xz: np.ndarray) -> tuple:
        s = self.size / (2 * self.extent)
        x = int(self.size / 2 + xz[0] * s)
        y = int(self.size / 2 + xz[-1] * s)
        return np.clip(x, 0, self.size - 1), np.clip(y, 0, self.size - 1)

    def render(self, *, agent_pos=None, trajectory: Sequence = (),
               gt_path: Sequence = (), nodes: Sequence = (),
               ghosts: Sequence = (), goal=None, edges: Sequence = (),
               predict_ghost=None, teacher_ghost=None) -> np.ndarray:
        import cv2
        img = np.full((self.size, self.size, 3), 255, np.uint8)

        def polyline(points, color, thick=2):
            pts = [self._to_px(np.asarray(p)[[0, 2]]) for p in points]
            for a, b in zip(pts, pts[1:]):
                cv2.line(img, a, b, color, thick)

        def dot(p, color, r=5):
            cv2.circle(img, self._to_px(np.asarray(p)[[0, 2]]), r, color, -1)

        for a, b in edges:                 # topo-graph edges under nodes
            polyline([a, b], EDGE_COLOR, 1)
        polyline(gt_path, GT_COLOR, 3)
        polyline(trajectory, PATH_COLOR, 2)
        for n in nodes:
            dot(n, NODE_COLOR, 5)
        for g in ghosts:
            dot(g, GHOST_COLOR, 4)
        if predict_ghost is not None:
            dot(predict_ghost, (0, 0, 0), 7)
        if teacher_ghost is not None:
            dot(teacher_ghost, (255, 0, 255), 7)
        if goal is not None:
            dot(goal, GOAL_COLOR, 8)
        if agent_pos is not None:
            dot(agent_pos, AGENT_COLOR, 6)
        return img


def pano_strip(rgb_views: np.ndarray, height: int = 128) -> np.ndarray:
    """(V, H, W, 3) -> one horizontal strip (navigator frame top band)."""
    import cv2
    tiles = [cv2.resize(v, (height, height)) for v in rgb_views]
    return np.concatenate(tiles, axis=1)


def navigator_video_frame(obs: Dict[str, np.ndarray], *, vis_info=None,
                          renderer: Optional[TopDownRenderer] = None,
                          **render_kwargs) -> np.ndarray:
    """Pano strip over top-down map (utils.py:670-752 composition)."""
    import cv2
    renderer = renderer or TopDownRenderer()
    top = renderer.render(**{**(vis_info or {}), **render_kwargs})
    strip = pano_strip(obs["rgb"]) if "rgb" in obs else None
    if strip is None:
        return top
    w = strip.shape[1]
    top = cv2.resize(top, (w, w // 2))
    return np.concatenate([strip, top], axis=0)


def planner_video_frame(obs: Dict[str, np.ndarray], *, vis_info=None,
                        renderer: Optional[TopDownRenderer] = None,
                        **render_kwargs) -> np.ndarray:
    """Planner-centric frame (utils.py:647-668): the topological map —
    graph edges, nodes, ghosts, the predicted ghost and teacher ghost —
    rendered full-size, with the panorama strip as a footer band."""
    import cv2
    renderer = renderer or TopDownRenderer()
    top = renderer.render(**{**(vis_info or {}), **render_kwargs})
    strip = pano_strip(obs["rgb"], height=64) if "rgb" in obs else None
    if strip is None:
        return top
    w = strip.shape[1]
    top = cv2.resize(top, (w, w))
    return np.concatenate([top, strip], axis=0)


def generate_video(frames: List[np.ndarray], video_dir: str,
                   episode_id: str, metrics: Dict[str, float],
                   fps: int = 8) -> str:
    """Write an episode video (utils.py:711-752 naming convention).
    cv2 mp4 writer; falls back to a PNG frame directory when no codec is
    available in the image."""
    import cv2
    os.makedirs(video_dir, exist_ok=True)
    metric_str = "-".join(f"{k}{v:.2f}" for k, v in metrics.items())
    base = os.path.join(video_dir, f"episode{episode_id}-{metric_str}")
    path = base + ".mp4"
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    if writer.isOpened():
        for f in frames:
            writer.write(f)
        writer.release()
        return path
    os.makedirs(base, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(base, f"frame{i:04d}.png"), f)
    return base
