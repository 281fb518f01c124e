"""Candidate waypoint predictor TRM + heatmap post-processing
(counterpart of `etpnav_tpu/models/waypoint.py`), with the train-time
waypoint augmentation `sample_candidates`.

The heatmap's softmax, row wrap, NMS and candidate slots run as one
launch of K-NMS (`ops/fused_nms.py`); the TRM's attention, with the
circular neighbour mask as its bias, runs through K-ATT.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from etpnav_tpu_torch.config import WaypointConfig
from etpnav_tpu_torch.models.bert_core import (
    BertDims,
    bert_stack,
    bert_stack_modules,
)
from etpnav_tpu_torch.ops.basic import Linear, mask_to_bias
from etpnav_tpu_torch.ops.fused_nms import heatmap_nms_fused
from etpnav_tpu_torch.ops.nms import extract_candidates


def circular_neighbor_mask(num_imgs: int, neighbor: int) -> np.ndarray:
    """(num_imgs, num_imgs) 0/1 mask where each view attends to itself and
    `neighbor` views on each side (waypoint_pred/utils.py:90-102)."""
    row = np.zeros(num_imgs)
    row[: neighbor + 1] = 1
    if neighbor:
        row[-neighbor:] = 1
    return np.stack([np.roll(row, i) for i in range(num_imgs)], 0)


class VisClassifier(nn.Module):
    def __init__(self, hidden: int, per_img_out: int):
        super().__init__()
        self.dense1 = Linear(hidden, hidden)
        self.dense2 = Linear(hidden, per_img_out)


class WaypointParams(nn.Module):
    def __init__(self, cfg: WaypointConfig):
        super().__init__()
        depth_flat = int(np.prod(cfg.depth_feat_shape))
        per_img_out = int(cfg.num_distances
                          * (cfg.num_angles / cfg.num_images))
        self.visual_fc_depth = Linear(depth_flat, cfg.hidden_size)
        self.waypoint_trm = bert_stack_modules(
            cfg.num_layers, cfg.hidden_size, cfg.hidden_size * 4)
        self.vis_classifier = VisClassifier(cfg.hidden_size, per_img_out)


def neighbor_bias(cfg: WaypointConfig, device) -> torch.Tensor:
    """(1, 1, V, V) fp32 additive attention bias of the TRM's circular
    neighbour mask, on `device`."""
    mask = torch.from_numpy(
        circular_neighbor_mask(cfg.num_images, cfg.neighbor).astype(bool))
    return mask_to_bias(mask.to(device))[None, None, :, :]


def waypoint_heatmap(params: WaypointParams, cfg: WaypointConfig,
                     depth_feats: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """depth_feats (B, 12, *depth_feat_shape) -> (B, 120, 12) logits,
    rotated so each image points at the middle of its sector. `bias` is
    `neighbor_bias` on the features' device, made by the caller once (an
    upload from pageable memory waits for the device, and a CUDA graph
    cannot capture it); without it the mask is uploaded here."""
    B = depth_feats.shape[0]
    x = depth_feats.reshape(B, cfg.num_images, -1)
    x = F.relu(params.visual_fc_depth(x))
    if bias is None:
        bias = neighbor_bias(cfg, x.device)
    dims = BertDims(cfg.hidden_size, cfg.num_heads, cfg.hidden_size * 4,
                    cfg.layer_norm_eps)
    x = bert_stack(params.waypoint_trm, x, bias, dims)
    h = F.relu(params.vis_classifier.dense1(x))
    h = params.vis_classifier.dense2(h)
    logits = h.reshape(B, cfg.num_angles, cfg.num_distances)
    return torch.roll(logits, -cfg.heatmap_offset, dims=1)


def heatmap_to_candidates(cfg: WaypointConfig,
                          heatmap_logits: torch.Tensor) -> dict:
    """Softmax -> wrap -> NMS -> K fixed candidate slots (argmax path):
    angle_idx, dist_idx, valid, img_idx (ccw view index), angles_ccw,
    distances (m), angle_fts (B,K,4), nms_map (B,120,12)."""
    A = cfg.num_angles
    nms_map, angle_idx, dist_idx, valid = heatmap_nms_fused(
        heatmap_logits.float(), cfg.max_predictions, cfg.nms_sigma)
    nms_map = nms_map[:, 1:-1, :]
    angles_cw = angle_idx.float() / A * 2.0 * math.pi
    return {
        "angle_idx": angle_idx, "dist_idx": dist_idx, "valid": valid,
        "img_idx": (12 - (angle_idx + 5) // 10) % 12,
        "angles_ccw": 2.0 * math.pi - angles_cw,
        "distances": (dist_idx.float() + 1.0) * 0.25,
        "angle_fts": angle_feature(angles_cw),
        "nms_map": nms_map,
    }


def sample_candidates(cfg: WaypointConfig, heatmap_logits: torch.Tensor,
                      nms_map: torch.Tensor,
                      generator: Optional[torch.Generator]) -> dict:
    """Train-time waypoint augmentation: keep the NMS-selected image
    sectors, but draw each candidate's (angle, distance) cell from a
    categorical over its source image's 10x12 heatmap region
    (Policy_ViewSelection_ETP.py:247-283). `jax.random.categorical`
    becomes `torch.multinomial` with the caller's generator."""
    B = heatmap_logits.shape[0]
    A, D = cfg.num_angles, cfg.num_distances
    per_img = A // cfg.num_images                       # 10
    angle_idx, _, valid = extract_candidates(nms_map, cfg.max_predictions)
    K = angle_idx.shape[1]
    img_idx_cw = ((angle_idx + 5) // 10) % 12           # clockwise view
    # undo the heatmap offset, then carve per-image regions
    regional = torch.roll(heatmap_logits, cfg.heatmap_offset, dims=1)
    regional = regional.reshape(B, cfg.num_images, per_img * D)
    region_logits = torch.gather(
        regional, 1, img_idx_cw[..., None].expand(B, K, per_img * D))
    probs = torch.softmax(region_logits.float(), dim=-1)
    draw = torch.multinomial(probs.reshape(B * K, -1), 1,
                             generator=generator).reshape(B, K)
    # map back to the absolute angle
    angle_ptr = torch.where(img_idx_cw != 0,
                            (img_idx_cw - 1) * per_img + 5,
                            torch.zeros_like(img_idx_cw))
    s_angle = draw // D + angle_ptr
    s_dist = draw % D
    angles_cw = s_angle.float() / A * 2.0 * math.pi
    return {
        "angle_idx": s_angle, "dist_idx": s_dist, "valid": valid,
        "img_idx": (12 - (s_angle + 5) // 10) % 12,
        "angles_ccw": 2.0 * math.pi - angles_cw,
        "distances": (s_dist.float() + 1.0) * 0.25,
        "angle_fts": angle_feature(angles_cw),
        "nms_map": nms_map,
    }


def angle_feature(headings: torch.Tensor) -> torch.Tensor:
    """(...,) heading rad -> (..., 4) [sin h, cos h, sin 0, cos 0]."""
    z = torch.zeros_like(headings)
    return torch.stack([torch.sin(headings), torch.cos(headings),
                        torch.sin(z), torch.cos(z)], dim=-1)


def pano_angle_features() -> np.ndarray:
    """Fixed 12-view counter-clockwise pano angle features."""
    idx = np.arange(12, dtype=np.float64)
    ang = (1.0 - idx / 12.0) * 2.0 * np.pi
    z = np.zeros_like(ang)
    return np.stack([np.sin(ang), np.cos(ang), np.sin(z), np.cos(z)],
                    axis=-1).astype(np.float32)
