"""HF goldens held against the port directly (counterparts of
tests/test_planner_parity.py:38,70 and tests/test_encoders.py:13,38).

HF `BertModel`, `XLMRobertaModel` and `CLIPVisionModelWithProjection`,
randomly initialised from a config at narrow widths, converted by the
port's converters and run through the port's forward passes in fp32 on
the CPU. Tolerances are the JAX tests': 2e-5 absolute for the language
path, 3e-5 for the CLIP tower, 2e-5 for CLIP's folded uint8 path against
`encode_image(preprocess_rgb(x))`, 1e-6 for the preprocessing against
torchvision-style normalisation.
"""

import numpy as np
import torch

from etpnav_tpu_torch.config import ClipConfig, PlannerConfig
from etpnav_tpu_torch.models import clip_vit, planner
from etpnav_tpu_torch.models.convert import (
    convert_hf_bert_encoder,
    load_jax_tree,
)
from etpnav_tpu_torch.ops.basic import init_weights

torch.set_num_threads(2)

CFG = PlannerConfig(
    vocab_size=99, hidden_size=48, num_heads=4, intermediate_size=96,
    max_position_embeddings=32, num_l_layers=3, num_pano_layers=2,
    num_x_layers=2, image_feat_size=24, depth_feat_size=12, use_bf16=False,
)
L = 12
CLIP_CFG = ClipConfig(image_size=32, patch_size=16, width=64, layers=2,
                      heads=4, output_dim=32)


def _planner_with_hf_text(cfg, model):
    """A planner with random weights whose text embeddings and language
    encoder come from the HF model (both loaded strictly)."""
    params = planner.PlannerParams(cfg)
    init_weights(params, torch.Generator().manual_seed(0))
    tree = convert_hf_bert_encoder(model.state_dict(), cfg.num_l_layers)
    load_jax_tree(params.embeddings, tree["embeddings"], "embeddings")
    load_jax_tree(params.lang_encoder, tree["lang_encoder"], "lang_encoder")
    return params


def _ids_and_mask(rng, vocab, lo=0):
    ids = rng.integers(lo, vocab, (2, L))
    mask = np.zeros((2, L), bool)
    mask[0, :7] = True
    mask[1, :] = True
    return ids, mask


def test_language_path_matches_hf_bert():
    from transformers import BertConfig, BertModel
    torch.manual_seed(0)
    model = BertModel(BertConfig(
        vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
        num_hidden_layers=CFG.num_l_layers,
        num_attention_heads=CFG.num_heads,
        intermediate_size=CFG.intermediate_size,
        max_position_embeddings=CFG.max_position_embeddings,
        hidden_act="gelu", layer_norm_eps=1e-12,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        add_pooling_layer=False).eval()
    params = _planner_with_hf_text(CFG, model)
    ids, mask = _ids_and_mask(np.random.default_rng(0), CFG.vocab_size)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        ours = planner.forward_txt(params, CFG, ids_t, mask_t).numpy()
        theirs = model(ids_t, attention_mask=mask_t.long()
                       ).last_hidden_state.numpy()
    np.testing.assert_allclose(ours[mask], theirs[mask], atol=2e-5)


def test_language_path_matches_hf_xlm_roberta():
    """RxR text encoder: eps 1e-5, pad id 1. Positions are plain arange(L)
    as in the reference's BertEmbeddings (vilmodel_cmt.py:64-66), so the
    golden runs HF with explicit position_ids; HF's own padding-offset
    positions must give a different result."""
    from transformers import XLMRobertaConfig, XLMRobertaModel
    cfg = PlannerConfig(
        vocab_size=251, hidden_size=48, num_heads=4, intermediate_size=96,
        max_position_embeddings=34, num_l_layers=3, num_pano_layers=2,
        num_x_layers=2, image_feat_size=24, depth_feat_size=12,
        use_bf16=False, lang_layer_norm_eps=1e-5, pad_token_id=1)
    torch.manual_seed(5)
    model = XLMRobertaModel(XLMRobertaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_l_layers,
        num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        hidden_act="gelu", layer_norm_eps=1e-5, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        add_pooling_layer=False).eval()
    params = _planner_with_hf_text(cfg, model)
    ids, mask = _ids_and_mask(np.random.default_rng(5), cfg.vocab_size, 2)
    ids[~mask] = 1                                    # xlm-r pad id
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        ours = planner.forward_txt(params, cfg, ids_t, mask_t).numpy()
        theirs = model(ids_t, attention_mask=mask_t.long(),
                       position_ids=torch.arange(L)[None].expand(2, L)
                       ).last_hidden_state.numpy()
        default_pos = model(ids_t, attention_mask=mask_t.long()
                            ).last_hidden_state.numpy()
    np.testing.assert_allclose(ours[mask], theirs[mask], atol=2e-5)
    assert np.abs(ours[mask] - default_pos[mask]).max() > 1e-3


def _hf_clip(seed):
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection
    cfg = CLIP_CFG
    torch.manual_seed(seed)
    return CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=cfg.width, intermediate_size=cfg.width * 4,
        num_hidden_layers=cfg.layers, num_attention_heads=cfg.heads,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        projection_dim=cfg.output_dim, hidden_act="quick_gelu",
        layer_norm_eps=cfg.layer_norm_eps, attention_dropout=0.0)).eval()


def _port_clip(model):
    params = clip_vit.ClipParams(CLIP_CFG)
    load_jax_tree(params, clip_vit.convert_hf_clip_vision(
        model.state_dict(), CLIP_CFG))
    return params


def test_clip_vit_matches_hf():
    model = _hf_clip(0)
    params = _port_clip(model)
    imgs = np.random.default_rng(0).standard_normal(
        (3, CLIP_CFG.image_size, CLIP_CFG.image_size, 3)).astype(np.float32)
    with torch.no_grad():
        ours = clip_vit.encode_image(params, CLIP_CFG, torch.from_numpy(imgs),
                                     dtype=torch.float32).numpy()
        theirs = model(torch.from_numpy(
            imgs.transpose(0, 3, 1, 2))).image_embeds.numpy()
    np.testing.assert_allclose(ours, theirs, atol=3e-5)


def test_clip_uint8_folded_path_matches_float_path():
    """encode_image_uint8 (normalisation folded into the patch product,
    `_patchify`'s (ps, ps, 3) order) equals preprocess_rgb +
    encode_image, on HF-converted weights, and both match HF on the
    normalised images."""
    model = _hf_clip(1)
    params = _port_clip(model)
    img = np.random.default_rng(1).integers(
        0, 256, (3, CLIP_CFG.image_size, CLIP_CFG.image_size, 3), np.uint8)
    x = torch.from_numpy(img)
    with torch.no_grad():
        ref = clip_vit.encode_image(params, CLIP_CFG,
                                    clip_vit.preprocess_rgb(x),
                                    dtype=torch.float32).numpy()
        fused = clip_vit.encode_image_uint8(params, CLIP_CFG, x,
                                            dtype=torch.float32).numpy()
        theirs = model(clip_vit.preprocess_rgb(x).permute(0, 3, 1, 2)
                       ).image_embeds.numpy()
    np.testing.assert_allclose(fused, ref, atol=2e-5)
    np.testing.assert_allclose(ref, theirs, atol=3e-5)


def test_clip_preprocess_matches_torchvision():
    img = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), np.uint8)
    ours = clip_vit.preprocess_rgb(torch.from_numpy(img)).numpy()
    x = torch.from_numpy(img.transpose(0, 3, 1, 2)).float() / 255.0
    mean = torch.tensor(clip_vit.CLIP_MEAN).view(1, 3, 1, 1)
    std = torch.tensor(clip_vit.CLIP_STD).view(1, 3, 1, 1)
    theirs = ((x - mean) / std).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, theirs, atol=1e-6)
