"""Proxy-task pretraining: MLM, SAP, MRC and OG over offline trajectory
batches (counterpart of `etpnav_tpu/training/pretrain.py`).

Capability target: pretrain_src/pretrain_src/train_r2r.py:70-462 — the
multi-task step loop with MetaLoader task mixing, the optimizer family
with no-decay groups (optim/misc.py:12-40), the warmup-linear or noam
schedule (optim/sched.py), gradient clipping and periodic validation
(validate_mlm / validate_sap, train_r2r.py:355-444).

Each step draws a task, runs its forward and loss, the backward and one
optimizer step, on one device or, with a `parallel/mesh.py` mesh, on
each rank of a dp x mp world (per-rank data, the task pick shared, the
gradients summed over dp, the parameters split over mp). Every
attention goes through K-ATT forward and K-ATT-BWD backward
(`ops/fused_attention.py`), with the attention-prob dropout inside the
kernels. bf16 activations where
`PlannerConfig.use_bf16` says so, at the JAX package's rounding points:
the text, pano, graph and local stacks in bf16; the MLM branch (the
text attending into the graph, and the tied decoder) in fp32, as there.
fp32 parameters and optimizer state. Dropout draws come from the
trainer's `torch.Generator` on its device; without one every dropout is
off (the deterministic forward the parity tests use).

`PretrainOptimizer` applies optax's chain as the JAX package builds it
(`make_optimizer`, pretrain.py:298-363): the global-norm clip, the
family's moments and masked weight decay in the family's order, then the
scheduled learning rate, and Lookahead around the whole chain for
rangerlars. A parameter a task's loss does not reach takes a zero
gradient, as under `jax.grad`: its moments decay and its weight decay
applies every step.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from etpnav_tpu_torch.config import ExperimentConfig, PlannerConfig
from etpnav_tpu_torch.data.pretrain_data import (
    MetaSampler,
    PretrainSampler,
    PretrainShapes,
)
from etpnav_tpu_torch.device import resolve_device
from etpnav_tpu_torch.models import dsv2_text, planner
from etpnav_tpu_torch.models.planner import (
    ClsHead,
    LocalEncoder,
    MLMHead,
    PlannerParams,
    RegionHead,
)
from etpnav_tpu_torch.ops.basic import LayerNorm, init_weights, mask_to_bias
from etpnav_tpu_torch.parallel import mesh as meshlib
from etpnav_tpu_torch.parallel import tensor_parallel
from etpnav_tpu_torch.parallel.mesh import Mesh
from etpnav_tpu_torch.training import checkpoints

logger = logging.getLogger("etpnav_tpu_torch.pretrain")

#: the key that marks a checkpoint written by `PretrainTrainer`
#: (`training/warm_start.py` and the runner tell it apart by this key)
CHECKPOINT_MARKER = "etpnav_tpu_torch.pretrain"

_INT_FIELDS = ("txt_ids", "txt_labels", "vp_nav", "gmap_step_ids",
               "global_act_labels", "last_step", "obj_labels")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class PretrainParams(PlannerParams):
    """The planner with the lang2visn branch, and the heads of the
    configured tasks (pretrain_cmt.py:50-78): `mlm_head` for MLM,
    `local_encoder` for MRC or OG, `image_classifier` for MRC, `og_head`
    for OG."""

    def __init__(self, cfg: PlannerConfig, tasks=("mlm", "sap"),
                 image_prob_size: int = 1000):
        super().__init__(cfg, use_lang2visn=True)
        if "mlm" in tasks:
            self.mlm_head = MLMHead(cfg)
        if "mrc" in tasks or "og" in tasks:
            self.local_encoder = LocalEncoder(cfg)
        if "mrc" in tasks:
            self.image_classifier = RegionHead(cfg.hidden_size,
                                               image_prob_size)
        if "og" in tasks:
            self.og_head = ClsHead(cfg.hidden_size)


def init_pretrain_params(cfg: PlannerConfig, generator: torch.Generator,
                         tasks=("mlm", "sap"),
                         image_prob_size: int = 1000) -> PretrainParams:
    params = PretrainParams(cfg, tasks, image_prob_size)
    init_weights(params, generator)
    return params


# ---------------------------------------------------------------------------
# forwards (shared trunk)
# ---------------------------------------------------------------------------

def _trunk(params: PretrainParams, cfg: PlannerConfig, batch: dict,
           generator: Optional[torch.Generator], train: bool):
    """Text encoder + pano encoder over every step + the dense `agg_w`
    aggregation of pano tokens into graph nodes -> (txt_embeds,
    gmap_img_fts (B, G, D) fp32)."""
    B, T, P = batch["vp_img"].shape[:3]
    txt = planner.forward_txt(params, cfg, batch["txt_ids"],
                              batch["txt_masks"], generator=generator,
                              train=train)
    pano, _ = planner.forward_panorama(
        params, cfg,
        batch["vp_img"].reshape(B * T, P, -1),
        batch["vp_dep"].reshape(B * T, P, -1),
        batch["vp_loc"].reshape(B * T, P, -1),
        batch["vp_nav"].reshape(B * T, P),
        batch["vp_mask"].reshape(B * T, P), generator=generator,
        train=train)
    pano_flat = pano.reshape(B, T * P, -1)
    step_tok_mask = batch["step_valid"].repeat_interleave(P, dim=1)
    pano_flat = pano_flat * step_tok_mask[..., None]
    gmap_img = torch.matmul(batch["agg_w"].to(pano_flat.dtype), pano_flat)
    return txt, gmap_img


def _local_vp_embeds(params: PretrainParams, cfg: PlannerConfig,
                     batch: dict, generator: Optional[torch.Generator],
                     train: bool):
    """Final-step pano tokens -> local cross-modal vp embeddings
    (B, 1+P, D), [stop] first, and the final step's token masks. MRC and
    OG read only the end viewpoint and the pano encoder treats steps
    independently, so the final step's inputs are gathered before the
    encoder: 1/T of the trajectory's pano work, the same result."""
    txt = planner.forward_txt(params, cfg, batch["txt_ids"],
                              batch["txt_masks"], generator=generator,
                              train=train)
    B = batch["vp_img"].shape[0]
    idx = torch.arange(B, device=batch["vp_img"].device)
    last = batch["last_step"]
    last_masks = batch["vp_mask"][idx, last]                 # (B, P)
    last_tokens, _ = planner.forward_panorama(
        params, cfg, batch["vp_img"][idx, last], batch["vp_dep"][idx, last],
        batch["vp_loc"][idx, last], batch["vp_nav"][idx, last], last_masks,
        generator=generator, train=train)                    # (B, P, D)
    return planner.forward_local(
        params, cfg, txt, batch["txt_masks"], last_tokens, last_masks,
        batch["vp_pos_fts"], generator=generator, train=train), last_masks


def forward_sap(params: PretrainParams, cfg: PlannerConfig, batch: dict,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """-> (B, G) global action logits (pretrain_cmt.py:223-263)."""
    txt, gmap_img = _trunk(params, cfg, batch, generator, train)
    nav = planner.forward_navigation(
        params, cfg, txt, batch["txt_masks"], gmap_img,
        batch["gmap_step_ids"], batch["gmap_pos_fts"], batch["gmap_mask"],
        batch["gmap_visited"], batch["gmap_pair"], generator=generator,
        train=train)
    return nav["global_logits"]


def forward_mlm(params: PretrainParams, cfg: PlannerConfig, batch: dict,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """-> (B, L, vocab) token logits through the lang2visn path (pretrain
    vilmodel.py:708-756 + the MLM head). The text stays fp32 through the
    stack, as in the JAX package."""
    txt, gmap_img = _trunk(params, cfg, batch, generator, train)
    ge = params.global_encoder
    pos = ge.gmap_pos_embeddings.ln(
        ge.gmap_pos_embeddings.dense(batch["gmap_pos_fts"]),
        cfg.vis_layer_norm_eps)
    gmap_embeds = (gmap_img + ge.gmap_step_embeddings[batch["gmap_step_ids"]]
                   + pos)
    lang_bias = mask_to_bias(batch["txt_masks"])[:, None, None, :]
    visn_bias = mask_to_bias(batch["gmap_mask"])[:, None, None, :]
    txt = planner.lang2visn_stack(
        ge.encoder, cfg, txt, gmap_embeds.to(txt.dtype), lang_bias,
        visn_bias, generator=generator, train=train)
    return planner.mlm_head(params.mlm_head,
                            params.embeddings.word_embeddings, txt,
                            cfg.lang_layer_norm_eps)


def forward_mrc(params: PretrainParams, cfg: PlannerConfig, batch: dict,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """-> (B, P, prob_size) region soft-label logits over the final
    viewpoint's tokens (pretrain_cmt.py:170-221; the [stop] row dropped,
    tasks.py:194)."""
    vp_embeds, _ = _local_vp_embeds(params, cfg, batch, generator, train)
    return planner.region_head(params.image_classifier, vp_embeds[:, 1:],
                               cfg.vis_layer_norm_eps)


def forward_og(params: PretrainParams, cfg: PlannerConfig, batch: dict,
               generator: Optional[torch.Generator] = None,
               train: bool = False) -> torch.Tensor:
    """-> (B, 1+P) object-grounding logits over the local vp tokens, -inf
    outside the object slots (nav_type 2; pretrain_cmt.py:287-317)."""
    vp_embeds, last_masks = _local_vp_embeds(params, cfg, batch, generator,
                                             train)
    logits = planner.cls_head(params.og_head, vp_embeds,
                              cfg.vis_layer_norm_eps)
    B = logits.shape[0]
    idx = torch.arange(B, device=logits.device)
    nav = batch["vp_nav"][idx, batch["last_step"]]           # (B, P)
    is_obj = torch.cat([torch.zeros_like(last_masks[:, :1]),
                        (nav == 2) & last_masks], dim=1)
    return torch.where(is_obj, logits, float("-inf"))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _finite_log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """log_softmax with -inf logits taken as -1e9."""
    return torch.log_softmax(
        torch.where(torch.isfinite(logits), logits, -1e9), dim=-1)


def _count(n: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A loss's denominator: the count summed over the dp group, as the
    JAX package takes it over the global batch, with no gradient (each
    rank's loss is then its share of the global mean, and the summed
    gradients are the global mean's)."""
    return n if mesh is None else mesh.dp_sum(n)


def _masked_mean(nll: torch.Tensor, labels: torch.Tensor,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean of the per-label NLL over labels >= 0 (the sum over
    max(count, 1))."""
    valid = labels >= 0
    return (torch.where(valid, nll, 0.0).sum()
            / _count(valid.sum(), mesh).clamp_min(1))


def _masked_mean_nll(logp: torch.Tensor, labels: torch.Tensor,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean NLL over labels >= 0 (the sum over max(count, 1))."""
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return _masked_mean(nll, labels, mesh)


def sap_loss(params, cfg: PlannerConfig, batch: dict,
             generator: Optional[torch.Generator] = None,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    logits = forward_sap(params, cfg, batch, generator, train=True)
    return _masked_mean_nll(_finite_log_softmax(logits),
                            batch["global_act_labels"], mesh)


def mlm_loss(params, cfg: PlannerConfig, batch: dict,
             generator: Optional[torch.Generator] = None,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean token NLL over the masked positions; under tensor
    parallelism the log-softmax runs over the vocabulary slices
    (`tensor_parallel.vocab_nll`)."""
    logits = forward_mlm(params, cfg, batch, generator, train=True)
    labels = batch["txt_labels"]
    nll = tensor_parallel.vocab_nll(logits, labels.clamp_min(0),
                                    params.embeddings.word_embeddings)
    return _masked_mean(nll, labels, mesh)


def _masked_kl(logits: torch.Tensor, batch: dict,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """KL(soft CLIP labels || predicted) averaged over the masked view
    tokens, 0 log 0 taken as 0 — the MRC loss and its validation metric."""
    logp = torch.log_softmax(logits, dim=-1)
    target = batch["vp_view_probs"]
    plogp = torch.where(target > 0,
                        target * torch.log(target.clamp_min(1e-12)), 0.0)
    kl = (plogp - target * logp).sum(-1)                     # (B, P)
    m = batch["vp_view_mrc_masks"]
    return (torch.where(m, kl, 0.0).sum()
            / _count(m.sum(), mesh).clamp_min(1))


def mrc_loss(params, cfg: PlannerConfig, batch: dict,
             generator: Optional[torch.Generator] = None,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """KL over the masked view tokens (pretrain_cmt.py:210-214)."""
    return _masked_kl(forward_mrc(params, cfg, batch, generator, train=True),
                      batch, mesh)


def og_loss(params, cfg: PlannerConfig, batch: dict,
            generator: Optional[torch.Generator] = None,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    logp = _finite_log_softmax(
        forward_og(params, cfg, batch, generator, train=True))
    nll = -logp.gather(-1, batch["obj_labels"][:, None])[:, 0]
    n = torch.tensor(nll.shape[0], device=nll.device)
    return nll.sum() / _count(n, mesh)


LOSS_FNS = {"mlm": mlm_loss, "sap": sap_loss, "mrc": mrc_loss,
            "og": og_loss}


# ---------------------------------------------------------------------------
# schedules (fp32 arithmetic, as the JAX package evaluates them)
# ---------------------------------------------------------------------------

_F = np.float32


def warmup_linear(step, lr: float, warmup: int, total: int) -> float:
    """optim/sched.py warmup_linear: ramp to lr over `warmup`, then linear
    decay to 0 at `total`."""
    step = _F(step)
    if step < warmup:
        return float(_F(lr) * step / _F(max(warmup, 1)))
    return float(_F(lr) * max((_F(total) - step) / _F(max(total - warmup, 1)),
                              _F(0.0)))


def noam_schedule(step, lr: float, warmup: int) -> float:
    """optim/sched.py:10-14: linear warmup then inverse-sqrt decay."""
    step = max(_F(step), _F(1.0))
    if step <= warmup:
        return float(_F(lr) * (step / _F(max(warmup, 1))))
    return float(_F(lr) * (_F(warmup ** 0.5) * step ** _F(-0.5)))


def schedule(cfg: ExperimentConfig):
    """The learning rate of update `count` (0 for the first update, as
    optax evaluates its schedule). warmup_linear is floored at 1e-8
    (get_lr_sched, optim/sched.py:27-29)."""
    pt = cfg.pretrain
    if pt.lr_sched == "noam":
        return lambda count: noam_schedule(count, pt.learning_rate,
                                           pt.warmup_steps)
    if pt.lr_sched == "warmup_linear":
        return lambda count: max(
            warmup_linear(count, pt.learning_rate, pt.warmup_steps,
                          pt.num_train_steps), float(_F(1e-8)))
    raise ValueError(f"unknown lr_sched {pt.lr_sched!r}")


# ---------------------------------------------------------------------------
# the optimizer family
# ---------------------------------------------------------------------------

OPTIMS = ("adam", "adamax", "adamw", "radam", "ralamb", "rangerlars")
_EPS = 1e-8
_RADAM_THRESHOLD = 5.0


def decay_mask(module: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether weight decay applies: not to biases or
    LayerNorms (the JAX package's `…/b`, `…bias`, `…/ln/…`, `…scale`
    path rule), decided here by module type and name, since a Linear's
    and a LayerNorm's `weight` share a name."""
    out = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out[name] = not (isinstance(m, LayerNorm) or pname == "bias")
    return out


def leaf_name(name: str) -> str:
    """The JAX package's leaf of a parameter: the stacks keep their layers
    on a leading axis of one leaf, so the layer index goes."""
    return re.sub(r"\.\d+\.", ".", name)


def _f32_pow(base: float, count: int) -> float:
    return float(_F(base) ** _F(count))


class PretrainOptimizer(torch.optim.Optimizer):
    """optax's chain for one `PretrainConfig.optim` over every parameter
    of the model, all in one group:

        clip_by_global_norm(grad_norm)
        adamw:  scale_by_adam, add_decayed_weights
        adam:   add_decayed_weights, scale_by_adam     (L2 before moments)
        adamax: add_decayed_weights, scale_by_adamax
        radam:  scale_by_radam, add_decayed_weights
        ralamb / rangerlars: scale_by_radam, add_decayed_weights,
                scale_by_trust_ratio
        scale_by_learning_rate(schedule)
        rangerlars: Lookahead(alpha, k) around the whole chain

    optax's formulas, not torch.optim's: the clip scales by max/norm only
    when norm >= max; Adamax's infinity moment is max(|g| + eps, b2 nu);
    RAdam rectifies from a threshold of 5 and puts eps outside the root;
    the trust ratio is taken per JAX leaf (a stack's layers together).
    Scalars (bias corrections, the schedule) in fp32 as JAX computes
    them. The counters live in the parameter group, so `state_dict()`
    holds only tensors and plain values. Under tensor parallelism the
    norms of the global clip and of the trust ratio are those of the
    whole leaves: a split leaf's squared norm is summed over its mp
    group, a replicated one counted once."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 cfg: ExperimentConfig, decay: Dict[str, bool]):
        named = list(named_params)
        pt = cfg.pretrain
        if pt.optim not in OPTIMS:
            raise ValueError(f"unknown optim {pt.optim!r}")
        self._lr = schedule(cfg)
        self._decay = [decay[n] for n, _ in named]
        leaves: Dict[str, int] = {}
        self._leaf = [leaves.setdefault(leaf_name(n), len(leaves))
                      for n, _ in named]
        self._num_leaves = len(leaves)
        specs = [getattr(p, "tp", None) for _, p in named]
        self._mp_group = next((s.group for s in specs if s is not None),
                              None)
        self._split = [s is not None for s in specs]
        super().__init__([p for _, p in named], {
            "optim": pt.optim, "betas": tuple(pt.betas),
            "weight_decay": pt.weight_decay, "grad_norm": pt.grad_norm,
            "lookahead_alpha": pt.lookahead_alpha,
            "lookahead_k": pt.lookahead_k, "count": 0})

    def _init_state(self, params: List[torch.Tensor], lookahead: bool):
        for p in params:
            st = self.state[p]
            if "mu" not in st:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
                if lookahead:
                    # a copy, not an alias: the slow weights live apart
                    st["slow"] = p.detach().clone()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("PretrainOptimizer takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        optim = group["optim"]
        b1, b2 = group["betas"]
        lookahead = optim == "rangerlars"
        self._init_state(params, lookahead)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]

        # clip_by_global_norm: (g / norm) * max where norm >= max
        norms = torch.stack(torch._foreach_norm(grads))
        if self._mp_group is None:
            norm = torch.linalg.vector_norm(norms)
        else:
            norm = self._whole_sq(norms.square(), torch.zeros(
                1, dtype=torch.long, device=norms.device).expand(
                    len(norms)), 1)[0].sqrt()
        keep = norm < group["grad_norm"]
        g = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(g, torch.where(keep, 1.0, group["grad_norm"]))

        wd = group["weight_decay"]
        dec = [i for i, d in enumerate(self._decay) if d]

        def add_decay(u):
            if wd:
                torch._foreach_add_([u[i] for i in dec],
                                    [params[i] for i in dec], alpha=wd)

        if optim in ("adam", "adamax"):
            add_decay(g)
        count = group["count"] + 1
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, g, alpha=1.0 - b1)
        mu_hat = torch._foreach_div(mus, float(1 - _F(_f32_pow(b1, count))))
        if optim == "adamax":
            torch._foreach_mul_(nus, b2)
            torch._foreach_maximum_(nus, torch._foreach_add(
                torch._foreach_abs(g), _EPS))
            u = torch._foreach_div(mu_hat, nus)
        else:
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, g, g, value=1.0 - b2)
            den = torch._foreach_div(nus, float(1 - _F(_f32_pow(b2, count))))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, _EPS)
            if optim in ("adam", "adamw"):
                u = torch._foreach_div(mu_hat, den)
            else:
                u = self._radam(mu_hat, den, b2, count)
        if optim not in ("adam", "adamax"):
            add_decay(u)
        if optim in ("ralamb", "rangerlars"):
            self._trust_ratio(u, params)
        # scale_by_learning_rate: the schedule at the update's count - 1
        torch._foreach_mul_(u, -float(_F(self._lr(count - 1))))
        group["count"] = count
        if not lookahead:
            torch._foreach_add_(params, u)
            return None
        # Lookahead (optim/lookahead.py): fast = p + u; every k-th update
        # the parameters become slow + alpha (fast - slow), which is
        # also the new slow copy
        if count % group["lookahead_k"]:
            torch._foreach_add_(params, u)
            return None
        slow = [self.state[p]["slow"] for p in params]
        fast = torch._foreach_add(params, u)
        torch._foreach_add_(slow, torch._foreach_sub(fast, slow),
                            alpha=group["lookahead_alpha"])
        torch._foreach_add_(params, torch._foreach_sub(slow, params))
        return None

    @staticmethod
    def _radam(mu_hat, den, b2: float, count: int):
        """optax scale_by_radam: the rectified update where the variance
        is tractable (rho >= 5), the bias-corrected momentum before."""
        ro_inf = _F(2.0 / (1.0 - b2) - 1.0)
        b2t = _F(_f32_pow(b2, count))
        ro = ro_inf - _F(2) * _F(count) * b2t / (_F(1) - b2t)
        if ro < _RADAM_THRESHOLD:
            return [m.clone() for m in mu_hat]
        r = np.sqrt((ro - _F(4)) * (ro - _F(2)) * ro_inf
                    / ((ro_inf - _F(4)) * (ro_inf - _F(2)) * ro))
        return torch._foreach_div(torch._foreach_mul(mu_hat, float(r)), den)

    def _trust_ratio(self, u, params):
        """optax scale_by_trust_ratio per JAX leaf: u * |p| / |u|, or u
        where either norm is 0."""
        dev = params[0].device
        leaf = torch.tensor(self._leaf, device=dev)

        def leaf_norms(ts):
            sq = torch.stack(torch._foreach_norm(ts)).square()
            if self._mp_group is not None:
                return self._whole_sq(sq, leaf, self._num_leaves).sqrt()
            return torch.zeros(self._num_leaves, device=dev).index_add_(
                0, leaf, sq).sqrt()

        pn, un = leaf_norms(params), leaf_norms(u)
        ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)[leaf]
        torch._foreach_mul_(u, list(ratio.unbind()))

    def _whole_sq(self, sq: torch.Tensor, index: torch.Tensor,
                  n: int) -> torch.Tensor:
        """Per-parameter squared norms summed into `n` bins by `index`,
        the split parameters' bins summed over the mp group. The bins are
        a product with a one-hot matrix, not an atomic `index_add`: every
        rank of the group must get the same bits, or the replicas part."""
        split = torch.tensor(self._split, device=sq.device)
        onehot = (index[None, :] == torch.arange(n, device=sq.device)[
            :, None]).to(sq.dtype)
        part = onehot @ torch.where(split, sq, 0.0)
        dist.all_reduce(part, group=self._mp_group)
        return part + onehot @ torch.where(split, 0.0, sq)


def make_optimizer(cfg: ExperimentConfig,
                   params: nn.Module) -> PretrainOptimizer:
    """`cfg.pretrain.optim` over every parameter of `params`, with the
    no-decay groups of `decay_mask`."""
    return PretrainOptimizer(params.named_parameters(), cfg,
                             decay_mask(params))


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def batch_to_device(batch: Dict[str, np.ndarray], device) -> dict:
    """A sampler batch as tensors on `device`: ids and labels int64,
    masks bool, features fp32. Every value's leading dim is the batch's
    (under a mesh, this rank's own rows)."""
    rows = {k: np.shape(v)[0] for k, v in batch.items()}
    if len(set(rows.values())) > 1:
        raise ValueError(f"batch_to_device: leading dims differ: {rows}")
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in _INT_FIELDS:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def pretrain_shapes(cfg: ExperimentConfig) -> PretrainShapes:
    """The sampler's shapes for `cfg`, as the JAX runner builds them
    (run.py:235-246): the planner's text length and feature sizes, the
    pretrain section's trajectory shape and MRC/OG layout, and the
    sampler's own max_gmap_len (48), not the planner's. A vocabulary
    smaller than BERT's word range (the tiny test config) draws its
    tokens from [10, vocab - 12) with [MASK] = 3, as the JAX tests'
    shapes do, so every id indexes the embedding table."""
    small = {}
    if cfg.planner.vocab_size <= PretrainShapes.mask_vocab_range[1]:
        small = {"mask_token_id": 3,
                 "mask_vocab_range": (10, cfg.planner.vocab_size - 12)}
    return PretrainShapes(**small,
        max_txt_len=cfg.planner.max_txt_len,
        max_traj_steps=cfg.pretrain.max_traj_steps,
        num_views=cfg.pretrain.views_per_step,
        image_feat_size=cfg.planner.image_feat_size,
        depth_feat_size=cfg.planner.depth_feat_size,
        vocab_size=cfg.planner.vocab_size,
        pad_token_id=cfg.planner.pad_token_id,
        image_prob_size=cfg.pretrain.image_prob_size,
        mrc_mask_prob=cfg.pretrain.mrc_mask_prob,
        num_objs=cfg.pretrain.num_objs)


class PretrainTrainer:
    """Task-mixed pretraining on one device: the GPU unless `device="cpu"`
    is passed. Parameters from a seeded CPU generator, dropout from a
    generator on the device seeded `seed + 1`.

    With a `mesh` (`parallel/mesh.py`; `device` is then this rank's) the
    parameters are broadcast from global rank 0 and split over mp by the
    rules; the data stream of dp slot d is seeded `seed + 100003 d` (the
    JAX package's per-process stream, pretrain.py:393; the mp peers of a
    slot draw the same batch), its dropout `seed + 1 + 100003 d`, and the
    task pick keeps the shared seed, so every rank trains the same task
    each step. Each loss is normalised by its dp-global count and the
    gradients are summed over dp; the returned loss is the global one.
    Checkpoints keep the one-process format (whole tensors), written by
    global rank 0 and re-split on load. The batches come from
    `batches`, any iterator of (task, batch) — a `MetaSampler` over
    `data/mp3d_pretrain.py`'s real-data source, or
    `data/pretrain_loader.py`'s `MetaLoader` — or by default from a
    `MetaSampler(seed)` over the synthetic `PretrainSampler(seed)` (the
    JAX package's streams at process 0). Validation draws from that
    synthetic sampler, and so advances its stream, as in the JAX
    package."""

    def __init__(self, cfg: ExperimentConfig, shapes: PretrainShapes, *,
                 seed: int = 0, num_scans: int = 8, scan_size: int = 24,
                 device="cuda", batches: Optional[Iterable] = None,
                 mesh: Optional[Mesh] = None):
        dsv2_text.refuse_training(cfg, "PretrainTrainer")
        self.cfg = cfg
        self.shapes = shapes
        self.device = resolve_device(device)
        self.mesh = mesh
        self.seed = seed
        pt = cfg.pretrain
        self.params = init_pretrain_params(
            cfg.planner, torch.Generator().manual_seed(seed), pt.tasks,
            pt.image_prob_size).to(self.device)
        if mesh is not None:
            meshlib.broadcast_params(self.params)
            meshlib.shard_params(mesh, self.params,
                                 {"": cfg.planner.num_heads})
        self.optimizer = make_optimizer(cfg, self.params)
        stride = meshlib.DP_SEED_STRIDE * self._dp_index
        self.sampler = PretrainSampler(shapes, seed=seed + stride,
                                       num_scans=num_scans,
                                       scan_size=scan_size)
        self.meta = iter(batches) if batches is not None else iter(
            MetaSampler(self.sampler, pt.batch_size, pt.task_ratios,
                        seed=seed, tasks=pt.tasks))
        self.generator = torch.Generator(
            device=self.device).manual_seed(seed + 1 + stride)
        self.step = 0

    @property
    def _dp_index(self) -> int:
        return 0 if self.mesh is None else self.mesh.dp_index

    def _put(self, batch: Dict[str, np.ndarray]) -> dict:
        return batch_to_device(batch, self.device)

    def train_step(self, task: str, batch: dict) -> torch.Tensor:
        """Forward, backward and one optimizer step on a device batch;
        returns the detached loss (reading it is the caller's sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = LOSS_FNS[task](self.params, self.cfg.planner, batch,
                              self.generator, mesh=self.mesh)
        loss.backward()
        if self.mesh is not None:
            self.mesh.sync_grads(list(self.params.parameters()))
            loss = self.mesh.dp_sum(loss)
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def train_steps(self, n: int, *, ckpt_dir: Optional[str] = None
                    ) -> Dict[str, float]:
        """n steps of task-mixed training; returns each task's mean loss.
        With ckpt_dir, validates and saves `model_step_N.pt` every
        cfg.pretrain.valid_steps (train_r2r.py:319-324 + ModelSaver)."""
        pt = self.cfg.pretrain
        losses: Dict[str, list] = {t: [] for t in pt.tasks}
        out: Dict[str, float] = {}
        for _ in range(n):
            task, batch = next(self.meta)
            losses[task].append(float(self.train_step(task,
                                                       self._put(batch))))
            if ckpt_dir and self.step % pt.valid_steps == 0:
                val = self.validate(n_batches=1)
                logger.info("step %d validation: %s", self.step, val)
                out.update({f"val_{k}": v for k, v in val.items()})
                self.save_checkpoint(os.path.join(
                    ckpt_dir, f"model_step_{self.step}.pt"))
        out.update({f"{k}_loss": float(np.mean(v))
                    for k, v in losses.items() if v})
        return out

    # ---- checkpointing (ModelSaver, pretrain utils/save.py:23-45) ----

    def save_checkpoint(self, path: str):
        """The one-process format; under a mesh every rank gathers (a
        collective), global rank 0 writes, and the others wait for it.
        `generators` holds each dp slot's dropout stream."""
        state = {
            CHECKPOINT_MARKER: 1,
            "params": meshlib.full_state_dict(self.params),
            "opt_state": meshlib.full_optimizer_state(self.optimizer),
            "step": self.step,
            "generator": self.generator.get_state(),
        }
        if self.mesh is not None and self.mesh.dp > 1:
            gens = meshlib.all_gather_object(self.generator.get_state())
            state["generators"] = gens[::self.mesh.mp]
            state["generator"] = gens[0]
        checkpoints.save_from_rank0(path, state)

    def load_checkpoint(self, path: str):
        """Any layout's checkpoint into this one: split parameters and
        their moments take their shards. A dp slot the checkpoint has no
        dropout stream for keeps its own."""
        state = checkpoints.load_checkpoint(path, map_location="cpu")
        if CHECKPOINT_MARKER not in state:
            raise ValueError(f"{path} is not a pretrain checkpoint of "
                             "etpnav_tpu_torch")
        meshlib.load_full_state_dict(self.params, state["params"])
        meshlib.load_full_optimizer_state(self.optimizer, state["opt_state"])
        self.step = int(state["step"])
        gens = state.get("generators", [state["generator"]])
        if self._dp_index < len(gens):
            self.generator.set_state(gens[self._dp_index])

    def resume_latest(self, ckpt_dir: str) -> bool:
        """Resume from the newest model_step_N (is_requeue,
        ss_trainer_ETP.py:216-236, applied to pretraining)."""
        ckpt = checkpoints.latest_checkpoint(ckpt_dir, pattern="model_step_*")
        if ckpt is None:
            return False
        self.load_checkpoint(ckpt)
        return True

    # ---- validation (train_r2r.py:355-444) ----

    @torch.no_grad()
    def _predict(self, forward, task: str):
        """A fresh `task` batch (it advances the training stream, as in
        the JAX package) and the argmax of `forward` on it (over the whole
        vocabulary when the MLM logits are split)."""
        batch = self.sampler.sample_batch(self.cfg.pretrain.batch_size, task)
        logits = forward(self.params, self.cfg.planner, self._put(batch))
        if task == "mlm":
            logits = tensor_parallel.full_vocab_logits(
                logits, self.params.embeddings.word_embeddings)
        return batch, logits.argmax(-1).cpu().numpy()

    @torch.no_grad()
    def validate(self, n_batches: int = 4) -> Dict[str, float]:
        tasks = self.cfg.pretrain.tasks
        mlm = [0, 0]
        sap = [0, 0]
        for _ in range(n_batches):
            batch, pred = self._predict(forward_mlm, "mlm")
            labels = batch["txt_labels"]
            valid = labels >= 0
            mlm[0] += int((pred[valid] == labels[valid]).sum())
            mlm[1] += int(valid.sum())
            batch, pred = self._predict(forward_sap, "sap")
            labels = batch["global_act_labels"]
            valid = labels >= 0
            sap[0] += int((pred[valid] == labels[valid]).sum())
            sap[1] += int(valid.sum())
        out = {"mlm_acc": mlm[0] / max(mlm[1], 1),
               "sap_acc": sap[0] / max(sap[1], 1)}
        if "mrc" in tasks or "og" in tasks:
            mrc_kl, og = [], [0, 0]
            for _ in range(n_batches):
                if "mrc" in tasks:
                    batch = self._put(self.sampler.sample_batch(
                        self.cfg.pretrain.batch_size, "mrc"))
                    mrc_kl.append(float(_masked_kl(forward_mrc(
                        self.params, self.cfg.planner, batch), batch)))
                if "og" in tasks:
                    batch, pred = self._predict(forward_og, "og")
                    og[0] += int((pred == batch["obj_labels"]).sum())
                    og[1] += len(pred)
            if "mrc" in tasks:
                out["mrc_kl"] = float(np.mean(mrc_kl))
            if "og" in tasks:
                out["og_acc"] = og[0] / max(og[1], 1)
        return out
