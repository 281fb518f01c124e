"""Schedule-sampling IL fine-tune trainer (counterpart of
`etpnav_tpu/training/finetune.py`): rollout, replay learn step, AdamW.

- The rollout (`training/rollout.py`) records one interval of frozen
  features, graph assembly and teacher actions.
- `learn_step` replays the differentiable path over all B*T recorded
  steps at once: text encoder, pano encoder over every step, the
  aggregation of pano tokens into graph nodes (from the sparse record,
  or with IL.agg_dense_device through the dense matrix rebuilt on the
  device), navigation encoder;
  cross-entropy against the teacher actions (ignore -100, normalised by
  the number of live steps, ss_trainer_ETP.py:892,1054-1056); backward;
  AdamW on the planner only (the reference freezes CLIP, depth and the
  waypoint predictor too). Every attention runs K-ATT forward and
  K-ATT-BWD backward, with its dropout inside the kernels.

With a `parallel/mesh.py` mesh the learn step runs on every rank of a
dp x mp world: each dp slot rolls out its own envs, the loss is
normalised by the dp-global count of live steps and the gradients are
summed over dp; under mp the trained planner is split by the rules, and
the rollout runs a whole copy of it on mp rank 0, whose record the mp
peers receive.

While tracing is on (`utils/logging.py`) an iteration is the spans
`train.rollout` and `train.learn` (key: the iteration); inside the
latter `learn.batch` (bucketing and upload), then `learn_step`'s
device-timed `learn.forward`, `learn.backward` (with the mesh's
gradient sum) and `learn.optimizer`.

bf16 activations where `use_bf16` says so; fp32 parameters and optimizer
state. Dropout draws come from the trainer's torch.Generator on its
device; without one (`generator=None`) every dropout is off, which is the
deterministic replay the parity tests use.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import warnings
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from etpnav_tpu_torch.config import ExperimentConfig, pick_bucket
from etpnav_tpu_torch.device import resolve_device
from etpnav_tpu_torch.metrics import aggregate
from etpnav_tpu_torch.models import dsv2_text, planner
from etpnav_tpu_torch.ops.basic import checkpointed, dropout
from etpnav_tpu_torch.parallel import mesh as meshlib
from etpnav_tpu_torch.parallel.mesh import Mesh
from etpnav_tpu_torch.training import checkpoints
from etpnav_tpu_torch.training.agent import (
    Agent,
    AgentParams,
    init_agent_params,
)
from etpnav_tpu_torch.training.pipeline import PipelinedRollout
from etpnav_tpu_torch.training.rollout import RolloutEngine, RolloutRecord
from etpnav_tpu_torch.utils import logging as tracing
from etpnav_tpu_torch.utils.logging import StepTimer, TensorboardLogger

# optax.adamw's default decay; torch.optim.AdamW's default (1e-2) differs
WEIGHT_DECAY = 1e-4
# drop_env on the RGB features (Policy_ViewSelection_ETP.py:102,345)
DROP_ENV = 0.4

_INT_FIELDS = ("txt_ids", "vp_nav", "agg_node_step", "agg_ent_slot",
               "agg_ent_tok", "gmap_step_ids", "teacher")


@torch.no_grad()
def dense_w_from_sparse(batch: dict, P: int) -> torch.Tensor:
    """The dense (B, T, G, S=T*P) fp32 aggregation matrix rebuilt on the
    batch's device from the sparse provenance record (IL.agg_dense_device).

    The sparse path's math: a node slot averages its visit step's valid
    tokens; a ghost slot sums its weighted (step, token) entries. W
    depends on record data only, so it carries no gradient; the replay's
    d(pano tokens) is then the transpose product instead of the gather's
    index backward."""
    node_step = batch["agg_node_step"]                        # (B, T, G)
    B, T, G = node_step.shape
    S = T * P
    vmask = batch["vp_mask"] & batch["step_valid"][..., None]  # (B, T, P)
    cnt = vmask.sum(-1).clamp_min(1).float()
    shares = vmask.float() / cnt[..., None]                   # (B, T, P)
    # W[b, t, g, u*P + p] = (node_step[b, t, g] == u) * shares[b, u, p]
    steps = torch.arange(T, device=node_step.device)
    node_oh = (node_step[..., None] == steps).float()         # (B,T,G,T)
    w = (node_oh[..., None] * shares[:, None, None]).reshape(B, T, G * S)
    # ghost entries: their share weights at (slot, token); padding
    # entries carry val=0 and add zero at slot 0, token 0
    flat = batch["agg_ent_slot"] * S + batch["agg_ent_tok"]   # (B, T, M)
    w.scatter_add_(2, flat, batch["agg_ent_val"].float())
    return w.reshape(B, T, G, S)


def aggregate_tokens(batch: dict, pano_flat: torch.Tensor,
                     dense: bool = False) -> torch.Tensor:
    """The recorded linear aggregation of (B, T*P, D) pano tokens into
    (B, T, G, D) graph node features, in fp32 and returned in
    pano_flat's dtype. Sparse (the default): node slots take their visit
    step's masked token mean, ghost slots the weighted sum of their
    gathered (step, token) entries. `dense` (IL.agg_dense_device): one
    product with `dense_w_from_sparse`'s matrix, whose backward is the
    transpose product instead of the gather's index backward."""
    B, T, G = batch["agg_node_step"].shape
    P = pano_flat.shape[1] // T
    dt = pano_flat.dtype
    pano32 = pano_flat.float()
    if dense:
        w = dense_w_from_sparse(batch, P)
        return torch.matmul(w.reshape(B, T * G, T * P), pano32) \
            .reshape(B, T, G, -1).to(dt)
    pano_bt = pano32.reshape(B, T, P, -1)
    vmask = batch["vp_mask"] & batch["step_valid"][..., None]
    cnt = vmask.sum(-1).clamp_min(1).float()                     # (B, T)
    step_mean = (pano_bt * vmask[..., None]).sum(2) / cnt[..., None]
    steps = torch.arange(T, device=pano32.device)
    node_oh = (batch["agg_node_step"][..., None] == steps).float()
    gmap_node = torch.einsum("btgu,bud->btgd", node_oh, step_mean)
    rows = torch.arange(B, device=pano32.device)[:, None, None]
    ent_feat = pano32[rows, batch["agg_ent_tok"]]                 # (B,T,M,D)
    ent_feat = ent_feat * batch["agg_ent_val"][..., None]
    slots = torch.arange(G, device=pano32.device)
    slot_oh = (batch["agg_ent_slot"][..., None] == slots).float()
    # padding entries carry val=0, so their slot-0 one-hot adds zero
    gmap_ghost = torch.einsum("btmg,btmd->btgd", slot_oh, ent_feat)
    return (gmap_node + gmap_ghost).to(dt)


def _pano_embeds(params, p, rgb, dep, loc, nav, mask, *, generator,
                 train):
    return planner.forward_panorama(params, p, rgb, dep, loc, nav, mask,
                                    generator=generator, train=train)[0]


def replay_logits(planner_params: planner.PlannerParams,
                  cfg: ExperimentConfig, batch: dict,
                  generator: Optional[torch.Generator] = None,
                  train: bool = True) -> torch.Tensor:
    """Differentiable replay of the rollout's decision path over all
    recorded steps at once: txt encoder -> pano encoder -> aggregation
    -> nav encoder -> (B, T, G) logits. With train=False (or no
    generator) and the same params this reproduces the rollout-time
    logits, which tests assert."""
    p = cfg.planner
    B, T, P = batch["vp_rgb"].shape[:3]
    G = batch["gmap_mask"].shape[2]
    if (cfg.il.remat_nav and not p.remat_scan
            and G >= cfg.il.remat_nav_min_gmap):
        # the large replay buckets only: the small ones fit without the
        # recompute's cost
        p = dataclasses.replace(p, remat_scan=True)

    txt = planner.forward_txt(planner_params, p, batch["txt_ids"],
                              batch["txt_masks"], generator=generator,
                              train=train)
    rgb = dropout(batch["vp_rgb"], DROP_ENV, generator, train)
    pano_args = (planner_params, p, rgb.reshape(B * T, P, -1),
                 batch["vp_dep"].reshape(B * T, P, -1),
                 batch["vp_loc"].reshape(B * T, P, -1),
                 batch["vp_nav"].reshape(B * T, P),
                 batch["vp_mask"].reshape(B * T, P))
    if cfg.il.remat:
        # backward recomputes the (B*T, P, D) pano activations
        pano_embeds = checkpointed(_pano_embeds, generator, *pano_args,
                                   train=train)
    else:
        pano_embeds = _pano_embeds(*pano_args, generator=generator,
                                   train=train)
    pano_flat = pano_embeds.reshape(B, T * P, -1)
    # zero tokens of invalid steps so aggregation only sees real data
    step_tok_mask = batch["step_valid"].repeat_interleave(P, dim=1)
    pano_flat = pano_flat * step_tok_mask[..., None]

    gmap_img = aggregate_tokens(batch, pano_flat, cfg.il.agg_dense_device)

    # navigation encoder over all steps at once
    L = txt.shape[1]
    txt_tiled = txt[:, None].expand(B, T, L, txt.shape[2]).reshape(
        B * T, L, -1)
    txt_mask_tiled = batch["txt_masks"][:, None].expand(B, T, L).reshape(
        B * T, L)
    nav = planner.forward_navigation(
        planner_params, p, txt_tiled, txt_mask_tiled,
        gmap_img.reshape(B * T, G, -1),
        batch["gmap_step_ids"].reshape(B * T, G),
        batch["gmap_pos_fts"].reshape(B * T, G, -1),
        batch["gmap_mask"].reshape(B * T, G),
        batch["gmap_visited"].reshape(B * T, G),
        batch["gmap_pair"].reshape(B * T, G, G),
        generator=generator, train=train)
    return nav["global_logits"].reshape(B, T, G)


def compute_il_loss(planner_params: planner.PlannerParams,
                    cfg: ExperimentConfig, batch: dict,
                    generator: Optional[torch.Generator] = None,
                    total_actions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Replay loss over a recorded rollout interval: cross-entropy of the
    replayed logits against the teacher (-100 ignored), -inf logits taken
    as -1e9, normalised by the number of valid steps: the batch's, or
    `total_actions` (the count over the dp group, so that the ranks'
    losses sum to the global batch's, as the JAX package takes it)."""
    logits = replay_logits(planner_params, cfg, batch, generator,
                           train=True)
    teacher = batch["teacher"]                        # (B, T), -100 ignore
    valid = (teacher >= 0) & batch["step_valid"]
    logp = torch.log_softmax(
        torch.where(torch.isfinite(logits), logits, -1e9), dim=-1)
    nll = -logp.gather(-1, teacher.clamp_min(0)[..., None])[..., 0]
    loss_sum = torch.where(valid, nll, 0.0).sum()
    if total_actions is None:
        total_actions = batch["step_valid"].sum()
    return cfg.il.ml_weight * loss_sum / total_actions.clamp_min(1)


def learn_step(planner_params: planner.PlannerParams,
               optimizer: torch.optim.Optimizer, cfg: ExperimentConfig,
               batch: dict, generator: Optional[torch.Generator] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Loss, backward and one AdamW step, in place; returns the detached
    loss (still on the device: reading it is the caller's sync). With a
    mesh, `batch` is this rank's share: the loss is normalised by the dp
    group's count of live steps, the gradients are summed over the group
    before the step (the unsplit ones then made mp rank 0's), and the
    returned loss is the global one."""
    optimizer.zero_grad(set_to_none=True)
    device = batch["step_valid"].device
    with tracing.sequence() as seq:
        seq.next("learn.forward", device=device)
        total = None
        if mesh is not None and mesh.dp > 1:
            total = mesh.dp_sum(batch["step_valid"].sum())
        loss = compute_il_loss(planner_params, cfg, batch, generator, total)
        seq.next("learn.backward", device=device)
        loss.backward()
        if mesh is not None:
            mesh.sync_grads(list(planner_params.parameters()))
            loss = mesh.dp_sum(loss)
        seq.next("learn.optimizer", device=device)
        optimizer.step()
    return loss.detach()


def frozen_roots(cfg: ExperimentConfig):
    """The planner subtrees MODEL.fix_{lang,pano}_embedding freeze
    (vilmodel_cmt.py:675-682)."""
    roots = set()
    if cfg.il.fix_lang_embedding:
        roots |= {"embeddings", "lang_encoder"}
    if cfg.il.fix_pano_embedding:
        roots |= {"img_embeddings"}
    return roots


def make_il_optimizer(cfg: ExperimentConfig,
                      planner_params: planner.PlannerParams
                      ) -> torch.optim.AdamW:
    """AdamW over the planner (optax.adamw's defaults: betas 0.9/0.999,
    eps 1e-8, weight decay 1e-4). Frozen subtrees take no gradient and
    stay out of the optimizer, so they neither move nor decay (the JAX
    package's `set_to_zero` branch)."""
    roots = frozen_roots(cfg)
    for name, child in planner_params.named_children():
        child.requires_grad_(name not in roots)
    trainable = [p for p in planner_params.parameters() if p.requires_grad]
    return torch.optim.AdamW(trainable, lr=cfg.il.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WEIGHT_DECAY)


def slice_record(rec: RolloutRecord, T_b: int, G_b: int) -> RolloutRecord:
    """The record cut to its first T_b steps and G_b graph slots."""
    T = rec.step_valid.shape[1]
    M_b = T_b * (rec.agg_ent_val.shape[2] // T)
    return dataclasses.replace(
        rec,
        vp_rgb=rec.vp_rgb[:, :T_b], vp_dep=rec.vp_dep[:, :T_b],
        vp_loc=rec.vp_loc[:, :T_b], vp_nav=rec.vp_nav[:, :T_b],
        vp_mask=rec.vp_mask[:, :T_b],
        agg_node_step=rec.agg_node_step[:, :T_b, :G_b],
        agg_ent_slot=rec.agg_ent_slot[:, :T_b, :M_b],
        agg_ent_tok=rec.agg_ent_tok[:, :T_b, :M_b],
        agg_ent_val=rec.agg_ent_val[:, :T_b, :M_b],
        gmap_step_ids=rec.gmap_step_ids[:, :T_b, :G_b],
        gmap_pos_fts=rec.gmap_pos_fts[:, :T_b, :G_b],
        gmap_mask=rec.gmap_mask[:, :T_b, :G_b],
        gmap_visited=rec.gmap_visited[:, :T_b, :G_b],
        gmap_pair=rec.gmap_pair[:, :T_b, :G_b, :G_b],
        teacher=rec.teacher[:, :T_b],
        step_valid=rec.step_valid[:, :T_b],
        logits=rec.logits[:, :T_b, :G_b],
    )


def bucket_record(rec: RolloutRecord, il) -> RolloutRecord:
    """Slice a recorded interval to its (T, G) demand buckets
    (IL.train_traj_buckets / train_gmap_buckets).

    Exact, not approximate: emitted gmap slots are prefix-ordered with
    padding at the end, steps beyond the last valid one are whole-row
    padding (teacher=-100, step_valid=False), ghost-provenance entries at
    step t reference only steps <= t and slots < the live slot count, and
    node visit-steps are <= their row's step. So slicing the record to
    T_b >= max valid steps and G_b >= max live slots removes only
    padding compute."""
    B, T = rec.step_valid.shape
    G = rec.gmap_mask.shape[2]
    if not (il.train_traj_buckets or il.train_gmap_buckets):
        return rec
    valid_t = rec.step_valid.any(0)
    T_need = int(valid_t.nonzero()[0].max()) + 1 if valid_t.any() else 1
    G_need = int(rec.gmap_mask.sum(-1).max())
    # several ranks: every rank learns at the bucket of the largest
    # demand (the task-sync dist.broadcast analogue, loader.py:56-59)
    T_need, G_need = meshlib.sync_max((T_need, G_need))
    T_b = pick_bucket(T_need, il.train_traj_buckets, T)
    G_b = pick_bucket(G_need, il.train_gmap_buckets, G)
    if (T_b, G_b) == (T, G):
        return rec
    return slice_record(rec, T_b, G_b)


def record_to_batch(rec: RolloutRecord, device="cuda") -> dict:
    """The learn step's inputs as tensors on `device` (ids as int64); the
    GPU unless `device="cpu"` is passed."""
    device = resolve_device(device)
    batch = {}
    for f in dataclasses.fields(rec):
        if f.name == "logits":
            continue
        t = torch.from_numpy(np.ascontiguousarray(getattr(rec, f.name)))
        if f.name in _INT_FIELDS:
            t = t.long()
        batch[f.name] = t.to(device, non_blocking=True)
    return batch


def _warn_short(what: str, got: int, want: int):
    """evaluate()/inference() must not silently deliver fewer episodes than
    requested."""
    if got < want:
        warnings.warn(
            f"{what} collected {got}/{want} requested episodes before the "
            "guard exhausted — the split may be smaller than requested or "
            "envs may be failing; results aggregate only what arrived.",
            RuntimeWarning, stacklevel=3)


class FinetuneTrainer:
    """The train / eval / inference loops. Runs on the GPU unless
    `device="cpu"` is passed; with no GPU and no `device="cpu"` it
    raises. With IL.is_requeue it resumes from the newest checkpoint in
    `ckpt_dir`. `tb_dir` takes tensorboard scalars (the loss each
    iteration; phase times and the learn buckets every 50). `envs` is one
    env pool, or a list of pools for the pipelined rollout (one engine
    per pool, seeds `seed + i`).

    With a `mesh` (`parallel/mesh.py`; `device` is then this rank's) the
    parameters start as global rank 0's (DDP's initial broadcast), and
    dp slot d draws its dropout from `seed + 1 + 100003 d`; the caller
    gives each dp slot its own envs. Under mp the trained planner
    (`train_planner`) is a split copy; the Agent keeps the whole planner,
    gathered after every learn step, for the rollout and evaluation.
    Evaluation stays per rank."""

    def __init__(self, cfg: ExperimentConfig, envs, *,
                 params: Optional[AgentParams] = None,
                 ckpt_dir: str = "checkpoints", seed: int = 0,
                 tb_dir: Optional[str] = None, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.envs = envs
        self.ckpt_dir = ckpt_dir
        self.device = resolve_device(device)
        self.mesh = mesh
        if params is None:
            params = init_agent_params(cfg, seed)
        # the Agent holds the parameters (frozen for its inference-mode
        # programs); without mp the planner is trained in place, so the
        # rollout always reads the newest planner
        self.agent = Agent(cfg, params, device=self.device)
        self.params = self.agent.params
        self.train_planner = self.params.planner
        stride = 0
        if mesh is not None:
            meshlib.broadcast_params(self.params)
            stride = meshlib.DP_SEED_STRIDE * mesh.dp_index
            if mesh.mp > 1:
                self.train_planner = meshlib.shard_params(
                    mesh, copy.deepcopy(self.params.planner),
                    {"": cfg.planner.num_heads})
        self.optimizer = make_il_optimizer(cfg, self.train_planner)
        if isinstance(envs, (list, tuple)):
            self.engine = PipelinedRollout(
                [RolloutEngine(cfg, self.agent, e, seed=seed + i)
                 for i, e in enumerate(envs)])
        else:
            self.engine = RolloutEngine(cfg, self.agent, envs, seed=seed)
        # per-iteration dropout draws, on the training device
        self.generator = torch.Generator(
            device=self.device).manual_seed(seed + 1 + stride)
        self.iteration = 0
        self.logs = defaultdict(list)
        self.timer = StepTimer()
        self.writer = TensorboardLogger(tb_dir)
        # (T, G) learn-bucket usage histogram
        self.bucket_counts: Dict[tuple, int] = {}
        if cfg.il.is_requeue:
            self.resume_latest()

    def close(self):
        """Stop the env pools' worker processes, if they have any."""
        pools = self.envs if isinstance(self.envs, (list, tuple)) \
            else [self.envs]
        for e in pools:
            if hasattr(e, "close"):
                e.close()

    def _refresh_rollout_planner(self):
        """Under mp, the whole planner of the rollout made the split
        trained one's (a gather over the mp group)."""
        if self.train_planner is not self.params.planner:
            meshlib.gather_into(self.params.planner, self.train_planner)

    def _split_planner(self):
        """Under mp, the split trained planner made the whole one's."""
        if self.train_planner is not self.params.planner:
            meshlib.load_full_state_dict(self.train_planner,
                                         self.params.planner.state_dict())

    def resume_latest(self, ckpt_dir: Optional[str] = None) -> bool:
        """IL.is_requeue: restore the newest checkpoint incl. optimizer
        state (ss_trainer_ETP.py:216-236)."""
        ckpt = checkpoints.latest_checkpoint(ckpt_dir or self.ckpt_dir)
        if ckpt is None:
            return False
        self.load_checkpoint(ckpt)
        return True

    def batch(self, rec: RolloutRecord) -> dict:
        return record_to_batch(rec, self.device)

    def train(self, iters: Optional[int] = None,
              gt_paths: Optional[dict] = None,
              save_every: Optional[int] = None) -> Dict[str, float]:
        """`iters` rollout + learn iterations; returns the means of the
        loss, of the two phases' seconds and of the iteration's graph
        counts (`Agent.perceive_graph_stats`, `Agent.depth_graph_stats`)
        over them. save_every:
        checkpoint to self.ckpt_dir every N iterations. Refuses a
        configuration with the DeepSeek-V2 text encoder, which is
        frozen."""
        dsv2_text.refuse_training(self.cfg, "FinetuneTrainer.train")
        il = self.cfg.il
        iters = iters if iters is not None else il.iters
        for _ in range(iters):
            ratio = il.sample_ratio ** (
                self.iteration // il.decay_interval + 1)
            graphs0 = self._graph_stats()
            with self.timer.phase("rollout", key=self.iteration):
                rec = None
                if self.mesh is None or self.mesh.mp_index == 0:
                    rec = self.engine.run("train", sample_ratio=ratio,
                                          gt_paths=gt_paths)
                if self.mesh is not None:
                    # the mp peers learn on mp rank 0's record, exactly
                    rec = self.mesh.broadcast_mp(rec)
            with self.timer.phase("learn", key=self.iteration):
                with tracing.span("learn.batch"):
                    brec = bucket_record(rec, il)
                    self.last_bucket = (brec.step_valid.shape[1],
                                        brec.gmap_mask.shape[2])
                    self.bucket_counts[self.last_bucket] = \
                        self.bucket_counts.get(self.last_bucket, 0) + 1
                    batch = self.batch(brec)
                loss = learn_step(self.train_planner, self.optimizer,
                                  self.cfg, batch, self.generator, self.mesh)
                # the learn phase ends on the device: read it inside
                loss = float(loss)
                self._refresh_rollout_planner()
            self.iteration += 1
            self.logs["IL_loss"].append(loss)
            self.logs["rollout_s"].append(self.timer.last("rollout"))
            self.logs["learn_s"].append(self.timer.last("learn"))
            for k, n in self._graph_stats().items():
                self.logs[k].append(n - graphs0[k])
            self.writer.add_scalar("loss/IL_loss", loss, self.iteration)
            if self.iteration % 50 == 0:
                self.writer.add_scalars(
                    {f"time/{k}": v for k, v in self.timer.means().items()},
                    self.iteration)
                self.writer.add_scalars(
                    {f"buckets/T{t}_G{g}": n for (t, g), n
                     in self.bucket_counts.items()}, self.iteration)
            if save_every and self.iteration % save_every == 0:
                self.save_checkpoint(os.path.join(
                    self.ckpt_dir, f"ckpt_iter{self.iteration}.pt"))
        return {k: float(np.mean(v[-iters:])) for k, v in self.logs.items()}

    def _graph_stats(self) -> dict:
        return {**self.agent.perceive_graph_stats(),
                **self.agent.depth_graph_stats()}

    def evaluate(self, episode_count: int,
                 gt_paths: Optional[dict] = None,
                 video_dir: Optional[str] = None) -> Dict[str, float]:
        """Eval loop (ss_trainer_ETP.py:513-641): argmax policy, metric
        aggregation over unique episodes. video_dir writes one navigator
        video per episode (VIDEO_DIR pipeline, `utils/visualization.py`)."""
        stat_eps: dict = {}
        guard = stalled = 0
        while len(stat_eps) < episode_count and guard < 10 * episode_count:
            before = len(stat_eps)
            self.engine.run("eval", stat_eps=stat_eps, gt_paths=gt_paths,
                            video_dir=video_dir)
            guard += 1
            stalled = stalled + 1 if len(stat_eps) == before else 0
            if stalled >= 3:
                break   # split exhausted / envs failing: stop early
        _warn_short("evaluate", len(stat_eps), episode_count)
        stats = aggregate(stat_eps)
        if stats:
            stats["n_episodes"] = float(len(stat_eps))
        return stats

    def inference(self, episode_count: int, predictions_file: str,
                  fmt: str = "r2r", sample: Optional[bool] = None) -> dict:
        """Leaderboard submission writer (ss_trainer_ETP.py:643-756).
        sample defaults to cfg.inference.sample (INFERENCE.SAMPLE)."""
        if sample is None:
            sample = self.cfg.inference.sample
        path_eps: dict = {}
        guard = stalled = 0
        while len(path_eps) < episode_count and guard < 10 * episode_count:
            before = len(path_eps)
            self.engine.run("infer", path_eps=path_eps,
                            sample_actions=sample)
            guard += 1
            stalled = stalled + 1 if len(path_eps) == before else 0
            if stalled >= 3:
                break
        _warn_short("inference", len(path_eps), episode_count)
        os.makedirs(os.path.dirname(predictions_file) or ".", exist_ok=True)
        if fmt == "r2r":
            payload = {k: v["path"] for k, v in path_eps.items()}
            with open(predictions_file, "w") as f:
                json.dump(payload, f, indent=2)
        else:  # rxr jsonl
            preds = []
            for k, v in path_eps.items():
                pts = [v["path"][0]["position"]]
                for p in v["path"][1:]:
                    if p["position"] != pts[-1]:
                        pts.append(p["position"])
                preds.append({"instruction_id": v["instruction_id"],
                              "path": pts})
            preds.sort(key=lambda x: x["instruction_id"])
            with open(predictions_file, "w") as f:
                for p in preds:
                    f.write(json.dumps(p) + "\n")
        return path_eps

    # ------------------------------------------------------------- ckpts

    def load_pretrained(self, path: str):
        """Warm start from a `PretrainTrainer` checkpoint of the port
        (`training/warm_start.py`): its trunk goes into the planner in
        place, and the optimizer starts fresh, as the reference's
        fine-tune stage does."""
        from etpnav_tpu_torch.training.warm_start import \
            load_pretrained_planner
        load_pretrained_planner(path, self.params.planner)
        self._split_planner()
        self.optimizer = make_il_optimizer(self.cfg, self.train_planner)

    def load_pretrained_planner(self, path: str):
        """MODEL.pretrained_path: a released PyTorch pretrain (or
        fine-tune) checkpoint, converted (vlnbert_init.py:21-30 key
        surgery) and loaded into the planner in place. The optimizer
        starts fresh, as the reference's fine-tune stage does."""
        from etpnav_tpu_torch.convert_cli import load_torch_state_dict
        from etpnav_tpu_torch.models.convert import (
            convert_planner,
            load_jax_tree,
        )
        sd = load_torch_state_dict(path, "planner")
        sd = sd.get("model", sd)
        p = self.cfg.planner
        load_jax_tree(self.params.planner, convert_planner(
            sd, p.num_l_layers, p.num_pano_layers, p.num_x_layers),
            "planner")
        self._split_planner()
        self.optimizer = make_il_optimizer(self.cfg, self.train_planner)

    def save_checkpoint(self, path: str):
        """The one-process format (the Agent's whole parameters, the
        optimizer's moments gathered whole); under a mesh every rank calls
        it and global rank 0 writes."""
        checkpoints.save_from_rank0(path, {
            "params": self.params.state_dict(),
            "opt_state": meshlib.full_optimizer_state(self.optimizer),
            "iteration": self.iteration,
        })

    def load_checkpoint(self, path: str):
        """A checkpoint of any layout; split parameters and their moments
        take their shards."""
        state = checkpoints.load_checkpoint(path, map_location=self.device)
        self.params.load_state_dict(state["params"])
        self._split_planner()
        meshlib.load_full_optimizer_state(self.optimizer, state["opt_state"])
        self.iteration = int(state["iteration"])
