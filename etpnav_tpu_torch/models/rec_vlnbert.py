"""Recurrent VLN-BERT (PREVALENT), the legacy waypoint-candidate policy
(counterpart of `etpnav_tpu/models/rec_vlnbert.py`).

Capability target: the reference's
vlnce_baselines/models/vlnbert/vlnbert_PREVALENT.py (VLNBert: 9 language
layers + 4 LXRT cross-modal layers with a recurrent [STATE] token) plus
the candidate-feature fusion its dagger_trainer drives through
``policy.net(mode='navigation', cand_rgb=..., cand_depth=...,
cand_direction=...)`` (dagger_trainer.py:291-302).

- ``encode_language`` (mode='language', vlnbert_PREVALENT.py:400-416):
  BERT embeddings -> the language stack -> (pooled state h_t, sequence
  features). RxR instructions arrive as precomputed features and skip the
  embedding table.
- ``nav_step`` (mode='visual', :419-447): the state token is prepended to
  the fused candidate tokens; each LXRT layer runs cross-attention
  ([state; cand] attends language[1:]), self-attention over [state;
  cand], then an FFN. The action logits are the last layer's state-row
  self-attention scores over the candidate rows, averaged over heads
  before the softmax (:340, :445); the new h_t is the pooler applied to
  the updated state token (:443).
- The reference's language-branch modules inside each LXRT layer are
  never called by its forward (dead parameters) and are not built.

Every attention goes through `ops/attention.py` (K-ATT forward, and
K-ATT-BWD under autograd), with this module's own mask value NEG_INF =
-1e9 as the bias. K-ATT returns no logits, so the state row's raw scores
(q0 . k^T * s + bias, fp32) are a plain product beside the kernel, as in
the JAX package. The JAX package stacks each stack's layers under
`lax.scan`; here each layer is a module of an `nn.ModuleList`, and
`sequence_nll` runs the recurrence over T as a Python loop that keeps
every step's graph for the backward pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from etpnav_tpu_torch.models.bert_core import (
    BertDims,
    BertEmbeddings,
    BertFFN,
    bert_embeddings,
    bert_ffn,
    bert_stack,
    bert_stack_modules,
)
from etpnav_tpu_torch.ops.attention import (
    AttentionBlock,
    cross_attention_block,
    mha,
)
from etpnav_tpu_torch.ops.basic import LayerNorm, Linear, dropout, init_weights

# masked keys and candidate slots (vlnbert_PREVALENT.py:393-396 uses
# -10000; -1e9 keeps masked rows numerically inert in fp32, as in JAX)
NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class RecVLNBertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    heads: int = 12
    intermediate: int = 3072
    la_layers: int = 9          # language self-attention depth
    vl_layers: int = 4          # cross-modal LXRT depth
    max_pos: int = 512
    type_vocab: int = 2
    eps: float = 1e-12
    rgb_dim: int = 512          # CLIP ViT-B/32 pooled feature
    depth_dim: int = 128        # DD-PPO ResNet bottleneck feature
    angle_dim: int = 4          # [sin h, cos h, sin e, cos e]
    max_cands: int = 12         # fixed candidate slots (masked)
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    pad_token_id: int = 0

    def dims(self) -> BertDims:
        return BertDims(self.hidden, self.heads, self.intermediate,
                        self.eps, self.hidden_dropout, self.attn_dropout)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class XLayer(nn.Module):
    """One LXRT layer's visual branch: cross-attention into the language
    (BertXAttention, :304), self-attention over [state; candidates]
    (:300) and the FFN (:301-302)."""

    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.cross = AttentionBlock(hidden)
        self.self = AttentionBlock(hidden)
        self.ffn = BertFFN(hidden, intermediate)


class RecVLNBertParams(nn.Module):
    def __init__(self, cfg: RecVLNBertConfig):
        super().__init__()
        D = cfg.hidden
        self.embeddings = BertEmbeddings(cfg.vocab_size, D, cfg.max_pos,
                                         cfg.type_vocab)
        self.lalayer = bert_stack_modules(cfg.la_layers, D, cfg.intermediate)
        self.addlayer = nn.ModuleList(XLayer(D, cfg.intermediate)
                                      for _ in range(cfg.vl_layers))
        self.pooler = Linear(D, D)
        # candidate fusion: a projection + LN per modality, merged linearly
        # (the VLN-CE waypoint codebase's vismerge pattern)
        self.rgb_proj = Linear(cfg.rgb_dim, D)
        self.rgb_ln = LayerNorm(D)
        self.depth_proj = Linear(cfg.depth_dim, D)
        self.depth_ln = LayerNorm(D)
        self.dir_proj = Linear(cfg.angle_dim, D)
        self.dir_ln = LayerNorm(D)
        self.vismerge = Linear(3 * D, D)
        self.vis_ln = LayerNorm(D)


def init_params(cfg: RecVLNBertConfig, seed: int = 0) -> RecVLNBertParams:
    """Random parameters from a seeded `torch.Generator`, on the CPU."""
    params = RecVLNBertParams(cfg)
    init_weights(params, torch.Generator().manual_seed(seed))
    return params


# ---------------------------------------------------------------------------
# language branch (mode='language')
# ---------------------------------------------------------------------------

def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) bool -> additive (B, 1, 1, L) fp32 bias, 0 or NEG_INF."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, NEG_INF)[:, None, None]


def _pooler(params: RecVLNBertParams, seq: torch.Tensor) -> torch.Tensor:
    """tanh(W seq[:, 0]) (BertPooler, vlnbert_PREVALENT.py:208-220)."""
    return torch.tanh(params.pooler(seq[:, 0]))


def encode_language(params: RecVLNBertParams, cfg: RecVLNBertConfig,
                    tokens: Optional[torch.Tensor], mask: torch.Tensor, *,
                    text_feats: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) token ids (R2R) or (B, L, hidden) features (RxR) -> (state
    h_t (B, H), lang_feats (B, L, H))."""
    if text_feats is not None:
        x = text_feats
    else:
        x = bert_embeddings(params.embeddings, tokens, cfg.eps,
                            hidden_dropout=cfg.hidden_dropout,
                            generator=generator, train=train)
    x = bert_stack(params.lalayer, x, mask_bias(mask), cfg.dims(),
                   generator=generator, train=train)
    return _pooler(params, x), x


# ---------------------------------------------------------------------------
# candidate fusion + navigation step (mode='visual')
# ---------------------------------------------------------------------------

def fuse_candidates(params: RecVLNBertParams, cfg: RecVLNBertConfig,
                    cand_rgb: torch.Tensor, cand_depth: torch.Tensor,
                    cand_dir: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False) -> torch.Tensor:
    """(B, K, rgb/depth/angle dims) -> (B, K, H) candidate tokens."""
    h = torch.cat([
        params.rgb_ln(F.relu(params.rgb_proj(cand_rgb)), cfg.eps),
        params.depth_ln(F.relu(params.depth_proj(cand_depth)), cfg.eps),
        params.dir_ln(F.relu(params.dir_proj(cand_dir)), cfg.eps),
    ], dim=-1)
    h = params.vis_ln(params.vismerge(h), cfg.eps)
    return dropout(h, cfg.hidden_dropout, generator, train)


def _self_att_scores(block: AttentionBlock, x: torch.Tensor,
                     bias: torch.Tensor, cfg: RecVLNBertConfig, *,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The self-attention sub-block, which also returns the raw
    pre-softmax scores of the state row (BertSelfAttention's
    attention_scores, vlnbert_PREVALENT.py:132; the action head reads row
    0, :340): the attention through K-ATT as in `self_attention_block`,
    and q0 . k^T * s + bias as an fp32 product beside it."""
    h = mha(block.attn, x, x, cfg.heads, bias, o=block.out.dense,
            attn_dropout=cfg.attn_dropout, generator=generator, train=train)
    h = dropout(h, cfg.hidden_dropout, generator, train)
    out = block.out.ln(x + h, cfg.eps)
    B, L, D = x.shape
    hd = D // cfg.heads
    q0 = block.attn.q(x[:, :1]).view(B, 1, cfg.heads, hd)
    k = block.attn.k(x).view(B, L, cfg.heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhk", q0.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd)) + bias.float()[:, :, 0]
    return out, scores               # (B, L, D), (B, heads, L)


def nav_step(params: RecVLNBertParams, cfg: RecVLNBertConfig,
             state: torch.Tensor, lang_feats: torch.Tensor,
             lang_mask: torch.Tensor, cand_rgb: torch.Tensor,
             cand_depth: torch.Tensor, cand_dir: torch.Tensor,
             cand_mask: torch.Tensor, *,
             generator: Optional[torch.Generator] = None,
             train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent navigation decision.

    state (B, H); lang_feats (B, L, H) from encode_language (slot 0 is the
    state's, dagger_trainer.py:272); candidates are fixed (B, K, .)
    tensors with cand_mask (B, K). Returns (logits (B, K) with masked
    slots at NEG_INF, new_state (B, H))."""
    B = lang_feats.shape[0]
    vis = fuse_candidates(params, cfg, cand_rgb, cand_depth, cand_dir,
                          generator=generator, train=train)
    x = torch.cat([state[:, None], vis], dim=1)        # [state; cands]
    # language keys leave out the state slot (vlnbert_PREVALENT.py:330)
    lang_kv = lang_feats[:, 1:]
    lang_bias = mask_bias(lang_mask[:, 1:])
    sv_mask = torch.cat([torch.ones(B, 1, dtype=torch.bool,
                                    device=cand_mask.device), cand_mask], 1)
    sv_bias = mask_bias(sv_mask)
    for layer in params.addlayer:
        x = cross_attention_block(
            layer.cross, x, lang_kv, cfg.heads, lang_bias, cfg.eps,
            hidden_dropout=cfg.hidden_dropout, attn_dropout=cfg.attn_dropout,
            generator=generator, train=train)
        x, scores = _self_att_scores(layer.self, x, sv_bias, cfg,
                                     generator=generator, train=train)
        x = bert_ffn(layer.ffn, x, cfg.eps, hidden_dropout=cfg.hidden_dropout,
                     generator=generator, train=train)
    # the mean over heads of the LAST layer's raw state->candidate scores
    logits = scores[:, :, 1:].mean(dim=1)              # (B, K)
    logits = torch.where(cand_mask, logits, NEG_INF)
    return logits, _pooler(params, x)


# ---------------------------------------------------------------------------
# supervised (DAgger) loss over recorded candidate steps
# ---------------------------------------------------------------------------

def sequence_nll(params: RecVLNBertParams, cfg: RecVLNBertConfig,
                 tokens: torch.Tensor, lang_mask: torch.Tensor,
                 cand_rgb: torch.Tensor, cand_depth: torch.Tensor,
                 cand_dir: torch.Tensor, cand_mask: torch.Tensor,
                 teacher: torch.Tensor, step_mask: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 train: bool = True) -> torch.Tensor:
    """The mean teacher-action cross-entropy over recorded trajectories.

    tokens (B, L); candidate tensors (B, T, K, .); teacher (B, T) int
    candidate indices; step_mask (B, T). The recurrence is the online
    decision path, replayed over the stored features
    (dagger_trainer.py:421-533)."""
    state, lang_feats = encode_language(params, cfg, tokens, lang_mask,
                                        generator=generator, train=train)
    logits = []
    for t in range(teacher.shape[1]):
        lg, state = nav_step(params, cfg, state, lang_feats, lang_mask,
                             cand_rgb[:, t], cand_depth[:, t],
                             cand_dir[:, t], cand_mask[:, t],
                             generator=generator, train=train)
        logits.append(lg)
    logp = F.log_softmax(torch.stack(logits, dim=1), dim=-1)   # (B, T, K)
    nll = -logp.gather(-1, teacher.long()[..., None])[..., 0]
    nll = torch.where(step_mask, nll, 0.0)
    return nll.sum() / torch.clamp_min(step_mask.sum(), 1)
