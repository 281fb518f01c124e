"""ETP agent runtime (counterpart of `etpnav_tpu/training/agent.py`):
the three device programs of a navigation step, in eager PyTorch.

- `encode_text`      instruction ids -> text memory (the BERT text stack,
                     or with `TextLLMConfig.enabled` the DeepSeek-V2
                     decoder of `models/dsv2_text.py`)
- `perceive`         raw 12-view RGB-D -> CLIP/depth features, waypoint
                     heatmap, NMS candidates, pano token embeddings
- `score_navigation` padded graph tensors -> per-node action logits

The pano token layout is fixed: K candidate slots then 12 view slots,
with validity masks. `Agent` takes the place of `JittedAgent`: it holds
the parameters on one device, accepts numpy or tensors, and returns
tensors on that device. On a CUDA device its `perceive` without a
generator (serving, eval) is the replay of one CUDA graph per input
signature (`ops/cuda_graph.py`; rgb's and depth's shapes, strides and
dtypes), captured at the signature's first call: the CLIP tower, the
depth trunk, the waypoint heatmap, K-NMS's candidate slots, the gathers
and the pano encoder in one graph launch, where the eager perceive
makes ~2,300 kernel launches (R2R width, B = 8) and reads nothing back
to the host. Its constants (`perceive_constants`) are uploaded once,
when the agent is built. The gate is what perceive can observe: a
generator (the train-time waypoint augmentation), the tracer on, or
torch.profiler recording in any thread (`profiling()`) run it eagerly,
so that spans and profiles see its kernels one by one; the eager
perceive still runs the depth trunk (`depth_resnet.encode_depth`, 53
convolutions and GroupNorms) as a CUDA graph of its own, one graph
launch where the eager trunk makes 1,328 kernel launches (96 images).
Inside the perceive graph's capture the trunk runs eagerly into it.

With the DeepSeek-V2 encoder, `Agent` casts the decoder's matrices to
the compute dtype in place (`dsv2_text.cast_matrices_`),
`Agent.encode_text` is the span `agent.text_llm` (device-timed), and
`text_stats()` counts the encodes, their valid tokens and the expert
rows. On a CUDA device the encoder, whose shapes are all fixed by the
(1, L) instruction and which reads nothing back to the host, is the
replay of one CUDA graph per input signature, as the depth trunk is:
one graph launch where the eager decoder makes ~1,300 kernel launches
(27 layers), which otherwise hold the interpreter for longer than the
device computes and so hold up the batcher's thread. While the tracer
is on it runs eagerly, so that each of its attention and expert
sublayers is a span (`agent.mla` / `agent.moe`) that times its own
kernels; so too while torch.profiler records, in any thread (replays
of this graph from the clients' threads under the profiler hung one
traced serving run of four on an H100, for a cause not yet known).
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from etpnav_tpu_torch.config import ExperimentConfig
from etpnav_tpu_torch.device import resolve_device
from etpnav_tpu_torch.models import (
    clip_vit,
    depth_resnet,
    dsv2_text,
    planner,
    waypoint,
)
from etpnav_tpu_torch.ops.basic import init_weights
from etpnav_tpu_torch.ops.cuda_graph import CapturedGraphs
from etpnav_tpu_torch.utils import logging as tracing


def profiling() -> bool:
    """Whether torch.profiler records, seen from any thread: the autograd
    profiler's `_profiler_enabled()` answers for the calling thread
    alone, the module's flag for the process."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False)) or torch.autograd._profiler_enabled()


def replays_graph(*xs: torch.Tensor) -> bool:
    """Whether a program call on `xs` may replay its CUDA graph: the
    tensors are on a CUDA device outside a capture, and neither the
    tracer nor torch.profiler (in any thread) is on, so that spans and
    profiles see the kernels one by one."""
    return (CapturedGraphs.engages(*xs) and not tracing.is_on()
            and not profiling())


class AgentParams(nn.Module):
    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        llm = cfg.text_llm.enabled
        self.planner = planner.PlannerParams(cfg.planner, text_stack=not llm)
        self.clip = clip_vit.ClipParams(cfg.clip)
        self.depth = depth_resnet.DepthParams(cfg.depth)
        self.waypoint = waypoint.WaypointParams(cfg.waypoint)
        if llm:
            dsv2_text.check_config(cfg.text_llm)
            self.text_llm = dsv2_text.TextLLMParams(cfg.text_llm,
                                                    cfg.planner.hidden_size)


def init_agent_params(cfg: ExperimentConfig, seed: int = 0) -> AgentParams:
    """Random parameters from a seeded `torch.Generator` (on the CPU; the
    `Agent` moves them to its device)."""
    params = AgentParams(cfg)
    init_weights(params, torch.Generator().manual_seed(seed))
    return params


def _dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.planner.use_bf16 else torch.float32


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def encode_text(params: AgentParams, cfg: ExperimentConfig,
                txt_ids: torch.Tensor, txt_masks: torch.Tensor,
                counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L) ids + mask -> (B, L, D) fp32 text memory. `counts` takes
    the DeepSeek-V2 encoder's counters (`dsv2_text.encode`)."""
    if cfg.text_llm.enabled:
        return dsv2_text.encode(params.text_llm, cfg, txt_ids, txt_masks,
                                counts)
    return planner.forward_txt(params.planner, cfg.planner, txt_ids,
                               txt_masks)


def perceive_constants(cfg: ExperimentConfig, device) -> dict:
    """The constant tensors of perceive on `device`: CLIP's normalisation
    fold vectors, the waypoint TRM's neighbour bias and the (12, 4) pano
    view angle features. A caller that perceives again makes them once
    and passes them (`Agent` does): each is an upload from pageable host
    memory, which waits for the device and which a CUDA graph cannot
    capture."""
    return {"clip_fold": clip_vit.fold_vectors(cfg.clip.patch_size, device),
            "neighbor_bias": waypoint.neighbor_bias(cfg.waypoint, device),
            "pano_loc": torch.from_numpy(
                waypoint.pano_angle_features()).to(device)}


def encode_panorama(params: AgentParams, cfg: ExperimentConfig,
                    rgb: torch.Tensor, depth: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    train_sampling: bool = False,
                    depth_trunk: Optional[Callable] = None,
                    consts: Optional[dict] = None) -> dict:
    """rgb (B, 12, H, W, 3) uint8, counter-clockwise views, view 0
    forward; depth (B, 12, Hd, Wd, 1) float in [0,1] or uint16. Returns
    pano token features + K candidate slots + the heatmap. With
    `train_sampling`, the candidates are re-drawn inside their sectors
    from `generator` (the waypoint augmentation). `depth_trunk`, given,
    maps the (B*12, Hd, Wd, 1) fp32 depth to what `encode_depth` returns
    for it (the `Agent`'s CUDA graphs). `consts` is `perceive_constants`
    on rgb's device; without it they are uploaded here."""
    wcfg = cfg.waypoint
    B, V = rgb.shape[:2]
    dtype = _dtype(cfg)
    if consts is None:
        consts = perceive_constants(cfg, rgb.device)
    if depth.dtype == torch.uint16:
        # uint16 transport: the host quantized [0,1] depth
        depth = depth.to(torch.float32) * (1.0 / 65535.0)

    rgb_feats = clip_vit.encode_image_uint8(                 # (B,12,512)
        params.clip, cfg.clip, rgb.reshape((B * V,) + rgb.shape[2:]),
        dtype=dtype, fold=consts["clip_fold"]).reshape(B, V, -1)
    depth = depth.reshape((B * V,) + depth.shape[2:])
    if depth_trunk is None:
        dep_spatial = depth_resnet.encode_depth(params.depth, cfg.depth,
                                                depth, dtype=dtype)
    else:
        dep_spatial = depth_trunk(depth)                     # (B*V,s,s,C)
    s, c = dep_spatial.shape[1], dep_spatial.shape[-1]
    # the waypoint predictor reads CHW-flattened depth features in
    # clockwise view order (Policy_ViewSelection_ETP.py:179-205)
    dep_chw = dep_spatial.permute(0, 3, 1, 2).reshape(B, V, c, s, s)
    cw = torch.cat([dep_chw[:, :1], dep_chw[:, 1:].flip(1)], dim=1)
    heatmap = waypoint.waypoint_heatmap(params.waypoint, wcfg,
                                        cw.reshape(B, V, -1),
                                        consts["neighbor_bias"])
    dep_pooled = dep_spatial.reshape(B, V, s * s, c).mean(2)  # (B,12,C)

    cands = waypoint.heatmap_to_candidates(wcfg, heatmap)
    if train_sampling:
        cands = waypoint.sample_candidates(wcfg, heatmap, cands["nms_map"],
                                           generator)
    img_idx = cands["img_idx"]                                # (B,K)
    cand_rgb = torch.gather(
        rgb_feats, 1, img_idx[..., None].expand(-1, -1, rgb_feats.shape[-1]))
    cand_dep = torch.gather(
        dep_pooled, 1, img_idx[..., None].expand(-1, -1, c))

    pano_loc = consts["pano_loc"]                             # (12,4)
    covered = torch.zeros(B, V, device=rgb_feats.device).scatter_reduce(
        1, img_idx, cands["valid"].float(), reduce="amax") > 0
    return {
        "rgb_fts": torch.cat([cand_rgb, rgb_feats], dim=1),
        "dep_fts": torch.cat([cand_dep, dep_pooled], dim=1),
        "loc_fts": torch.cat([cands["angle_fts"],
                              pano_loc[None].expand(B, V, 4)], dim=1),
        "nav_types": torch.cat([cands["valid"].long(),
                                torch.zeros_like(covered, dtype=torch.long)],
                               dim=1),
        "view_masks": torch.cat([cands["valid"], ~covered], dim=1),
        "cand_valid": cands["valid"], "cand_angles": cands["angles_ccw"],
        "cand_distances": cands["distances"], "cand_img_idx": img_idx,
        "heatmap": heatmap,
    }


def embed_panorama(params: AgentParams, cfg: ExperimentConfig,
                   vp_feats: dict) -> dict:
    """Token features -> pano embeddings + their masked average."""
    pano_embeds, pano_masks = planner.forward_panorama(
        params.planner, cfg.planner, vp_feats["rgb_fts"],
        vp_feats["dep_fts"], vp_feats["loc_fts"], vp_feats["nav_types"],
        vp_feats["view_masks"])
    m = pano_masks[..., None].to(pano_embeds.dtype)
    avg = (pano_embeds * m).sum(1) / torch.clamp_min(m.sum(1), 1e-6)
    return {"pano_embeds": pano_embeds, "avg_pano_embeds": avg,
            "pano_masks": pano_masks}


def score_navigation(params: AgentParams, cfg: ExperimentConfig,
                     txt_embeds: torch.Tensor, txt_masks: torch.Tensor,
                     gmap: dict) -> dict:
    return planner.forward_navigation(
        params.planner, cfg.planner, txt_embeds, txt_masks,
        gmap["img_fts"], gmap["step_ids"], gmap["pos_fts"], gmap["mask"],
        gmap["visited"], gmap["pair_dists"])


def _traced_trunk(graphs: CapturedGraphs, device: torch.device,
                  depth: torch.Tensor) -> torch.Tensor:
    """The depth trunk through `graphs`, as the span `agent.depth`."""
    with tracing.span("agent.depth", device=device,
                      graph=CapturedGraphs.engages(depth)):
        return graphs(depth)


def perceive(params: AgentParams, cfg: ExperimentConfig, rgb: torch.Tensor,
             depth: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             train_sampling: bool = False,
             depth_trunk: Optional[Callable] = None,
             consts: Optional[dict] = None) -> dict:
    """The per-step perception path: frozen encoders + waypoint heatmap +
    NMS candidates (re-drawn with `train_sampling`) + pano-token
    embedding. `depth_trunk` and `consts` as in `encode_panorama`."""
    wp = encode_panorama(params, cfg, rgb, depth, generator, train_sampling,
                         depth_trunk, consts)
    wp.update(embed_panorama(params, cfg, {
        k: wp[k] for k in ("rgb_fts", "dep_fts", "loc_fts", "nav_types",
                           "view_masks")}))
    return wp


class Agent:
    """The agent's parameters on one device and its three programs.

    Runs on the GPU unless `device="cpu"` is passed; with no GPU and no
    `device="cpu"` it raises. Inputs may be numpy arrays or tensors.
    `perceive_graph_stats()` counts the whole perceive's graph replays
    and captures, and its eager calls on a CUDA device (a generator, the
    tracer, the profiler, or an enclosing capture).
    `depth_graph_stats()` counts the depth trunk's graph replays and
    captures, and its eager calls on a CUDA device (made only inside
    an enclosing capture, the perceive graph's); each call is the span
    `agent.depth` (device-timed, with `graph` True where it replayed or
    captured)."""

    def __init__(self, cfg: ExperimentConfig,
                 params: Optional[AgentParams] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_agent_params(cfg, cfg.seed)
        if (cfg.text_llm.enabled and self.device.type == "cuda"
                and not cfg.planner.use_bf16):
            raise ValueError("the DeepSeek-V2 text encoder runs in bf16 on "
                             "a CUDA device (K-MOE, and K-ATT at head width "
                             "192, are bf16 kernels): set "
                             "planner.use_bf16")
        self.params = params.to(self.device).eval().requires_grad_(False)
        depth_p, depth_cfg, dtype = self.params.depth, cfg.depth, _dtype(cfg)
        self._depth_graphs = CapturedGraphs(
            lambda d: depth_resnet.encode_depth(depth_p, depth_cfg, d,
                                                dtype=dtype))
        self._depth_trunk = functools.partial(_traced_trunk,
                                              self._depth_graphs, self.device)
        # the whole perceive without a generator; it closes over no
        # `self`, so a dropped agent frees its graphs' pools at once
        self._perceive_graphs = CapturedGraphs(functools.partial(
            perceive, self.params, cfg, depth_trunk=self._depth_trunk,
            consts=perceive_constants(cfg, self.device)))
        if cfg.text_llm.enabled:
            dsv2_text.cast_matrices_(self.params.text_llm, dtype)
            # a parameter loaded as a view of a larger buffer (one flat
            # draw of every weight) gets a storage of its own, so that
            # the buffer's fp32 copy of the cast matrices is freed
            for t in [*self.params.parameters(), *self.params.buffers()]:
                if t.untyped_storage().nbytes() > t.nbytes:
                    t.data = t.data.clone()
        self._text_graphs = CapturedGraphs(self._encode_llm)
        # moe_rows, moe_groups, moe_rows_elsewhere, valid text tokens
        self._text_counts = torch.zeros(4, dtype=torch.int64,
                                        device=self.device)
        self._text_encodes = 0
        self._text_lock = threading.Lock()

    def _t(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def encode_text(self, txt_ids, txt_masks) -> torch.Tensor:
        with tracing.span("agent.upload", device=self.device):
            ids, mask = self._t(txt_ids).long(), self._t(txt_masks).bool()
        if not self.cfg.text_llm.enabled:
            counts = torch.zeros(4, dtype=torch.int64, device=self.device)
            counts[3] = mask.sum()
            out = encode_text(self.params, self.cfg, ids, mask)
        else:
            x = torch.stack([ids, mask.long()])
            graph = replays_graph(x)
            with tracing.span("agent.text_llm", device=self.device,
                              graph=graph):
                out, counts = (self._text_graphs(x) if graph
                               else self._encode_llm(x))
        with self._text_lock:         # encodes run on many client threads
            self._text_encodes += 1
            self._text_counts += counts
        return out

    def _encode_llm(self, x: torch.Tensor) -> tuple:
        """The DeepSeek-V2 encoder on x = stack([ids, mask]) (2, B, L):
        (text memory, its int64 (4,) counters)."""
        counts = torch.zeros(4, dtype=torch.int64, device=x.device)
        out = encode_text(self.params, self.cfg, x[0], x[1].bool(), counts)
        return out, counts

    def text_stats(self) -> dict:
        """Instructions encoded, their valid tokens, and the DeepSeek-V2
        encoder's expert rows: token-expert rows the held experts
        computed (`moe_rows`), held experts with at least one row summed
        over the expert-layer calls (`moe_groups`), and routings to
        experts held elsewhere (`moe_rows_elsewhere`); 0 for BERT. Reads
        device counters (waits for the device)."""
        with self._text_lock:
            encodes = self._text_encodes
            rows, groups, elsewhere, tokens = self._text_counts.tolist()
        return {"text_encodes": encodes, "text_tokens": tokens,
                "moe_rows": rows, "moe_groups": groups,
                "moe_rows_elsewhere": elsewhere}

    @torch.inference_mode()
    def perceive(self, rgb, depth,
                 generator: Optional[torch.Generator] = None) -> dict:
        """With a generator (on this device), the train-time waypoint
        augmentation draws the candidates. Without one, on a CUDA device,
        the whole perceive is the replay of one CUDA graph per input
        signature, unless the tracer is on or torch.profiler records in
        any thread: then it runs eagerly (its depth trunk still a graph),
        so that the spans and the profile see its kernels one by one."""
        with tracing.span("agent.upload", device=self.device):
            rgb, depth = self._t(rgb), self._t(depth)
        g = self._perceive_graphs
        if generator is None and replays_graph(rgb, depth):
            return g(rgb, depth)
        return g.eager(rgb, depth, generator,
                       train_sampling=generator is not None)

    def perceive_graph_stats(self) -> dict:
        g = self._perceive_graphs
        return {"perceive_graph_replays": g.replays,
                "perceive_eager_calls": g.eager_calls,
                "perceive_graph_captures": g.captures}

    def depth_graph_stats(self) -> dict:
        g = self._depth_graphs
        return {"depth_graph_replays": g.replays,
                "depth_eager_calls": g.eager_calls,
                "depth_graph_captures": g.captures}

    @torch.inference_mode()
    def score_navigation(self, txt_embeds, txt_masks, gmap: dict) -> dict:
        with tracing.span("agent.upload", device=self.device):
            g = {k: self._t(v) for k, v in gmap.items()}
            g["step_ids"] = g["step_ids"].long()
            txt_embeds = self._t(txt_embeds)
            txt_masks = self._t(txt_masks).bool()
        return score_navigation(self.params, self.cfg, txt_embeds,
                                txt_masks, g)
