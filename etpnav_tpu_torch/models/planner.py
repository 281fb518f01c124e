"""Cross-modal topological planner (counterpart of
`etpnav_tpu/models/planner.py`):

- forward_txt        BERT embeddings + the language encoder
- forward_panorama   RGB/depth/angle fusion + the pre-norm pano encoder
- forward_navigation graph node embedding + the graph-aware cross-modal
                     layers (sprel attention bias) + the SAP head
- pretraining only: `lang2visn_stack` (the text attending into the graph
  through the same cross-modal layers, for MLM), `forward_local` (the
  local viewpoint encoder, for MRC and OG) and the MLM, region and
  classification heads

Inputs are fixed-shape padded tensors with boolean masks, as in the JAX
package; ragged assembly happens host-side in `graph/topo_map.py`. With
`train=True` and a generator, every dropout of the reference runs (BERT
hidden and attention-prob dropout, the SAP head's 0.1); without a
generator the training forward is the deterministic one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from etpnav_tpu_torch.config import PlannerConfig
from etpnav_tpu_torch.models.bert_core import (
    BertDims,
    BertEmbeddings,
    BertFFN,
    PrenormStack,
    bert_embeddings,
    bert_ffn,
    bert_stack,
    bert_stack_modules,
    prenorm_stack,
)
from etpnav_tpu_torch.ops.attention import (
    AttentionBlock,
    cross_attention_block,
    self_attention_block,
)
from etpnav_tpu_torch.ops.basic import (
    LayerNorm,
    Linear,
    checkpointed,
    dropout,
    gelu_erf,
    init_weights,
    mask_to_bias,
    matmul_f32,
)
from etpnav_tpu_torch.parallel import tensor_parallel

# the SAP head's dropout (vilmodel_cmt.py NextActionPrediction)
SAP_DROPOUT = 0.1

# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class ImgEmbeddings(nn.Module):
    def __init__(self, cfg: PlannerConfig):
        super().__init__()
        D = cfg.hidden_size
        self.img_linear = Linear(cfg.image_feat_size, D)
        self.img_ln = LayerNorm(D)
        self.loc_linear = Linear(cfg.angle_feat_size, D)
        self.loc_ln = LayerNorm(D)
        self.nav_type_embedding = nn.Parameter(
            torch.zeros(cfg.num_nav_types, D))
        self.ln = LayerNorm(D)
        self.pano_encoder = PrenormStack(cfg.num_pano_layers, D,
                                         cfg.intermediate_size)
        if cfg.use_depth_embedding:
            self.dep_linear = Linear(cfg.depth_feat_size, D)
            self.dep_ln = LayerNorm(D)


class PosEmbeddings(nn.Module):
    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.dense = Linear(d_in, hidden)
        self.ln = LayerNorm(hidden)


class XLayer(nn.Module):
    """GraphLXRTXLayer (vilmodel_cmt.py:365-398): cross-attention into
    the text, graph self-attention, FFN. Pretraining adds the language
    branch (`lang_self_att`, `lang_ffn`) that `lang2visn_stack` runs
    (pretrain vilmodel.py:400-411)."""

    def __init__(self, cfg: PlannerConfig, use_lang2visn: bool = False):
        super().__init__()
        self.visual_attention = AttentionBlock(cfg.hidden_size)
        self.visn_self_att = AttentionBlock(cfg.hidden_size)
        self.visn_ffn = BertFFN(cfg.hidden_size, cfg.intermediate_size)
        if use_lang2visn:
            self.lang_self_att = AttentionBlock(cfg.hidden_size)
            self.lang_ffn = BertFFN(cfg.hidden_size, cfg.intermediate_size)


def x_stack_modules(cfg: PlannerConfig,
                    use_lang2visn: bool = False) -> nn.ModuleList:
    return nn.ModuleList(XLayer(cfg, use_lang2visn)
                         for _ in range(cfg.num_x_layers))


class GlobalEncoder(nn.Module):
    def __init__(self, cfg: PlannerConfig, use_lang2visn: bool = False):
        super().__init__()
        D = cfg.hidden_size
        self.gmap_pos_embeddings = PosEmbeddings(cfg.angle_feat_size + 3, D)
        self.gmap_step_embeddings = nn.Parameter(
            torch.zeros(cfg.max_action_steps, D))
        self.encoder = x_stack_modules(cfg, use_lang2visn)
        if cfg.graph_sprels:
            self.sprel_linear = Linear(1, 1)


class SapHead(nn.Module):
    """NextActionPrediction: Linear, ReLU, LN, Linear(h, 1). The
    pretraining heads RegionClassification (Linear(h, label_dim) last)
    and ClsPrediction have the same tree."""

    def __init__(self, hidden: int, out: int = 1):
        super().__init__()
        self.dense1 = Linear(hidden, hidden)
        self.ln = LayerNorm(hidden)
        self.dense2 = Linear(hidden, out)


class RegionHead(SapHead):
    """RegionClassification for MRC (pretrain_cmt.py:12-23)."""


class ClsHead(SapHead):
    """ClsPrediction for OG (pretrain_cmt.py:25-35)."""


class LocalEncoder(nn.Module):
    """LocalVPEncoder (pretrain vilmodel.py:537-568): a 14-d viewpoint
    position embedding and cross-modal layers over the final viewpoint's
    tokens (the MRC/OG branch)."""

    def __init__(self, cfg: PlannerConfig):
        super().__init__()
        self.vp_pos_embeddings = PosEmbeddings(cfg.angle_feat_size * 2 + 6,
                                               cfg.hidden_size)
        self.encoder = x_stack_modules(cfg)


class MLMHead(nn.Module):
    """BertOnlyMLMHead (vilmodel_cmt.py:258-299): transform dense + LN;
    the decoder is tied to the word embeddings, so only its output bias
    is a parameter here."""

    def __init__(self, cfg: PlannerConfig):
        super().__init__()
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.bias.zero_()


class TypeEmbeddings(nn.Module):
    """The one table of BertEmbeddings that the pano embedding reads
    (token type 1), for a planner whose text memory comes from another
    encoder (`TextLLMConfig`), which builds no BERT text stack."""

    def __init__(self, type_vocab: int, hidden: int):
        super().__init__()
        self.token_type_embeddings = nn.Parameter(
            torch.zeros(type_vocab, hidden))


class PlannerParams(nn.Module):
    """With `text_stack=False` the BERT text embeddings and language
    encoder are not built (only the token-type table the pano embedding
    reads)."""

    def __init__(self, cfg: PlannerConfig, use_lang2visn: bool = False,
                 text_stack: bool = True):
        super().__init__()
        if text_stack:
            self.embeddings = BertEmbeddings(
                cfg.vocab_size, cfg.hidden_size,
                cfg.max_position_embeddings, cfg.type_vocab_size)
            self.lang_encoder = bert_stack_modules(
                cfg.num_l_layers, cfg.hidden_size, cfg.intermediate_size)
        else:
            self.embeddings = TypeEmbeddings(cfg.type_vocab_size,
                                             cfg.hidden_size)
        self.img_embeddings = ImgEmbeddings(cfg)
        self.global_encoder = GlobalEncoder(cfg, use_lang2visn)
        self.global_sap_head = SapHead(cfg.hidden_size)


def init_planner_params(cfg: PlannerConfig, generator: torch.Generator,
                        use_lang2visn: bool = False) -> PlannerParams:
    params = PlannerParams(cfg, use_lang2visn)
    init_weights(params, generator)
    return params


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _dims(cfg: PlannerConfig, eps: float) -> BertDims:
    return BertDims(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                    eps, cfg.hidden_dropout, cfg.attn_dropout)


def _compute_dtype(use_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if use_bf16 else torch.float32


def forward_txt(params: PlannerParams, cfg: PlannerConfig,
                txt_ids: torch.Tensor, txt_masks: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """(B, L) token ids + (B, L) bool mask -> (B, L, D) fp32 text memory."""
    x = bert_embeddings(params.embeddings, txt_ids, cfg.lang_layer_norm_eps,
                        hidden_dropout=cfg.hidden_dropout,
                        generator=generator, train=train)
    bias = mask_to_bias(txt_masks)[:, None, None, :]
    x = x.to(_compute_dtype(cfg.use_bf16))
    return bert_stack(params.lang_encoder, x, bias,
                      _dims(cfg, cfg.lang_layer_norm_eps),
                      generator=generator, train=train).float()


def forward_panorama(params: PlannerParams, cfg: PlannerConfig,
                     rgb_fts: torch.Tensor, dep_fts: torch.Tensor,
                     loc_fts: torch.Tensor, nav_types: torch.Tensor,
                     view_masks: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False):
    """Panorama view fusion + pre-norm encoder. rgb_fts (B,P,512),
    dep_fts (B,P,128), loc_fts (B,P,4), nav_types (B,P) int, view_masks
    (B,P) bool -> (pano_embeds (B,P,D) fp32, view_masks)."""
    ie = params.img_embeddings
    eps = cfg.vis_layer_norm_eps
    x = ie.img_ln(ie.img_linear(rgb_fts), eps)
    if cfg.use_depth_embedding:
        x = x + ie.dep_ln(ie.dep_linear(dep_fts), eps)
    x = x + ie.loc_ln(ie.loc_linear(loc_fts), eps)
    x = x + ie.nav_type_embedding[nav_types]
    # + token_type_embeddings(1) from the text embedding table
    x = x + params.embeddings.token_type_embeddings[1][None, None, :]
    x = dropout(ie.ln(x, eps), cfg.hidden_dropout, generator, train)
    bias = mask_to_bias(view_masks)[:, None, None, :]
    # torch MultiheadAttention LayerNorms inside the pre-norm layer: 1e-5
    x = x.to(_compute_dtype(cfg.use_bf16))
    x = prenorm_stack(ie.pano_encoder, x, bias, _dims(cfg, 1e-5), eps,
                      generator=generator, train=train)
    return x.float(), view_masks


def _x_layer(layer: XLayer, cfg: PlannerConfig, visn: torch.Tensor,
             txt: torch.Tensor, txt_bias: torch.Tensor,
             visn_bias: torch.Tensor, *,
             generator: Optional[torch.Generator] = None,
             train: bool = False) -> torch.Tensor:
    eps = cfg.vis_layer_norm_eps
    drop = {"hidden_dropout": cfg.hidden_dropout, "generator": generator,
            "train": train}
    visn = cross_attention_block(layer.visual_attention, visn, txt,
                                 cfg.num_heads, txt_bias, eps,
                                 attn_dropout=cfg.attn_dropout, **drop)
    visn = self_attention_block(layer.visn_self_att, visn, cfg.num_heads,
                                visn_bias, eps,
                                attn_dropout=cfg.attn_dropout, **drop)
    return bert_ffn(layer.visn_ffn, visn, eps, **drop)


def _x_stack(layers: nn.ModuleList, cfg: PlannerConfig, visn: torch.Tensor,
             txt: torch.Tensor, txt_bias: torch.Tensor,
             visn_bias: torch.Tensor, *,
             generator: Optional[torch.Generator] = None,
             train: bool = False) -> torch.Tensor:
    """The cross-modal layers in turn. With `cfg.remat_scan`, each layer
    is checkpointed: backward keeps only the (B, G, D) layer input and
    recomputes the layer's attention internals, with the same dropout
    draws (`checkpointed`). No effect where no gradient is recorded."""
    for layer in layers:
        if cfg.remat_scan:
            visn = checkpointed(_x_layer, generator, layer, cfg, visn, txt,
                                txt_bias, visn_bias, train=train)
        else:
            visn = _x_layer(layer, cfg, visn, txt, txt_bias, visn_bias,
                            generator=generator, train=train)
    return visn


def _lang2visn_layer(layer: XLayer, cfg: PlannerConfig,
                     lang: torch.Tensor, visn: torch.Tensor,
                     lang_bias: torch.Tensor, visn_bias: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False) -> torch.Tensor:
    """GraphLXRTXLayer.forward_lang2visn (vilmodel_cmt.py:400-411): the
    text cross-attends into the graph through `visual_attention` (its
    weights shared with the graph-into-text direction), then the text
    self-attention and FFN."""
    eps = cfg.vis_layer_norm_eps
    drop = {"hidden_dropout": cfg.hidden_dropout, "generator": generator,
            "train": train}
    lang = cross_attention_block(layer.visual_attention, lang, visn,
                                 cfg.num_heads, visn_bias, eps,
                                 attn_dropout=cfg.attn_dropout, **drop)
    lang = self_attention_block(layer.lang_self_att, lang, cfg.num_heads,
                                lang_bias, eps,
                                attn_dropout=cfg.attn_dropout, **drop)
    return bert_ffn(layer.lang_ffn, lang, eps, **drop)


def lang2visn_stack(layers: nn.ModuleList, cfg: PlannerConfig,
                    lang: torch.Tensor, visn: torch.Tensor,
                    lang_bias: torch.Tensor, visn_bias: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False) -> torch.Tensor:
    """The MLM path over the global encoder's cross-modal layers (pretrain
    vilmodel.py:731-741): (B, L, D) text, (B, G, D) graph -> (B, L, D),
    in the text's dtype."""
    for layer in layers:
        lang = _lang2visn_layer(layer, cfg, lang, visn, lang_bias,
                                visn_bias, generator=generator, train=train)
    return lang


def forward_local(params: nn.Module, cfg: PlannerConfig,
                  txt_embeds: torch.Tensor, txt_masks: torch.Tensor,
                  vp_tok_embeds: torch.Tensor, vp_tok_masks: torch.Tensor,
                  vp_pos_fts: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  train: bool = False) -> torch.Tensor:
    """LocalVPEncoder.forward (pretrain vilmodel.py:561-568).
    vp_tok_embeds (B, P, D) pano-encoder outputs of the final step,
    vp_tok_masks (B, P) bool, vp_pos_fts (B, 1+P, 14) with row 0 the
    [stop] token -> (B, 1+P, D) fp32, [stop] first. `params` holds a
    `local_encoder`."""
    le = params.local_encoder
    B, _, D = vp_tok_embeds.shape
    stop = vp_tok_embeds.new_zeros(B, 1, D)
    x = torch.cat([stop, vp_tok_embeds], dim=1)
    x = x + le.vp_pos_embeddings.ln(le.vp_pos_embeddings.dense(vp_pos_fts),
                                    cfg.vis_layer_norm_eps)
    masks = torch.cat([vp_tok_masks.new_ones(B, 1), vp_tok_masks], dim=1)
    txt_bias = mask_to_bias(txt_masks)[:, None, None, :]
    visn_bias = mask_to_bias(masks)[:, None, None, :]
    dtype = _compute_dtype(cfg.use_bf16)
    visn = _x_stack(le.encoder, cfg, x.to(dtype), txt_embeds.to(dtype),
                    txt_bias, visn_bias, generator=generator, train=train)
    return visn.float()


def _head(params: SapHead, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = F.relu(params.dense1(x))
    return params.dense2(params.ln(h, eps))


def region_head(params: RegionHead, x: torch.Tensor,
                eps: float) -> torch.Tensor:
    """(..., D) -> (..., label_dim) region soft-label logits."""
    return _head(params, x, eps)


def cls_head(params: ClsHead, x: torch.Tensor, eps: float) -> torch.Tensor:
    """(..., D) -> (...) scalar logits."""
    return _head(params, x, eps)[..., 0]


def mlm_head(params: MLMHead, word_embeddings: torch.Tensor,
             x: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D) -> vocab logits, the decoder tied to the word embeddings
    (pretrain_cmt.py:80-83): the table cast to x's dtype, the product
    accumulated in fp32 and rounded once (`matmul_f32`), plus the fp32
    bias. The gradient reaches the word embeddings through this product
    and through their lookup. With the table split over a tensor-parallel
    group, the logits are this rank's vocabulary slice
    (`tensor_parallel.vocab_nll` takes them)."""
    h = gelu_erf(params.transform(x))
    h = tensor_parallel.vocab_input(params.ln(h, eps), word_embeddings)
    logits = matmul_f32(h, word_embeddings.t().to(h.dtype))
    return logits + params.bias


def sap_head(params: SapHead, x: torch.Tensor, eps: float, *,
             generator: Optional[torch.Generator] = None,
             train: bool = False) -> torch.Tensor:
    """NextActionPrediction -> (B, G) scalar logits."""
    h = F.relu(params.dense1(x))
    h = dropout(params.ln(h, eps), SAP_DROPOUT, generator, train)
    return params.dense2(h)[..., 0]


def forward_navigation(params: PlannerParams, cfg: PlannerConfig,
                       txt_embeds: torch.Tensor, txt_masks: torch.Tensor,
                       gmap_img_fts: torch.Tensor,
                       gmap_step_ids: torch.Tensor,
                       gmap_pos_fts: torch.Tensor, gmap_masks: torch.Tensor,
                       gmap_visited_masks: torch.Tensor,
                       gmap_pair_dists: torch.Tensor, *,
                       generator: Optional[torch.Generator] = None,
                       train: bool = False) -> dict:
    """Global action scoring. gmap_img_fts (B,G,D), gmap_step_ids (B,G),
    gmap_pos_fts (B,G,7), masks (B,G) bool, pair_dists (B,G,G) ->
    {'gmap_embeds': (B,G,D), 'global_logits': (B,G)}; visited and padded
    slots get -inf. The sprel bias carries its gradient to
    `sprel_linear` through the graph self-attention's d(bias)."""
    ge = params.global_encoder
    eps = cfg.vis_layer_norm_eps
    pos = ge.gmap_pos_embeddings.ln(
        ge.gmap_pos_embeddings.dense(gmap_pos_fts), eps)
    x = gmap_img_fts + ge.gmap_step_embeddings[gmap_step_ids] + pos

    txt_bias = mask_to_bias(txt_masks)[:, None, None, :]
    visn_bias = mask_to_bias(gmap_masks)[:, None, None, :]
    if cfg.graph_sprels:
        sl = ge.sprel_linear
        sprel = gmap_pair_dists * sl.weight[0, 0] + sl.bias[0]
        visn_bias = visn_bias + sprel[:, None, :, :]

    nav_bf16 = (cfg.use_bf16 if cfg.nav_use_bf16 is None
                else cfg.nav_use_bf16)
    dtype = _compute_dtype(nav_bf16)
    visn = _x_stack(ge.encoder, cfg, x.to(dtype), txt_embeds.to(dtype),
                    txt_bias, visn_bias, generator=generator, train=train)
    gmap_embeds = visn.float()

    logits = sap_head(params.global_sap_head, gmap_embeds, eps,
                      generator=generator, train=train)
    neg_inf = torch.full_like(logits, float("-inf"))
    logits = torch.where(gmap_visited_masks, neg_inf, logits)
    logits = torch.where(gmap_masks, logits, neg_inf)
    return {"gmap_embeds": gmap_embeds, "global_logits": logits}
