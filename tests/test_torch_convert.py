"""The port's released-checkpoint converters against the JAX package's.

The released layouts are built with the reference-named torch
transcriptions the JAX tests already have (`TorchNavCMT` / `TorchTRM`
of tests/test_released_layout_roundtrip.py, `_TorchDepthEncoder` of
tests/test_encoders.py) and with seeded tensors under the openai CLIP
`visual.*` names (no transcription); every weight is drawn from a seeded
numpy stream. For each layout:

- the port's converter returns the same tree as the JAX converter, leaf
  by leaf, with `np.array_equal` (same keys, shapes and values);
- where a transcription exists, the port's forward on the converted
  weights matches it at the JAX tests' tolerances: 3e-5 absolute for the
  planner and the waypoint predictor (tests/test_released_layout_
  roundtrip.py), 5e-5 for the depth trunk (tests/test_encoders.py);
- the depth convs' OIHW -> HWIO -> OIHW round trip is exact
  (`torch.equal`);
- a missing key raises in the converter, and a tree with a key too many
  or too few raises in the strict `load_jax_tree`.

`convert_cli`'s key surgery on raw files is tested in
tests/test_torch_cli.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn

from etpnav_tpu.config import DepthEncoderConfig as JaxDepthConfig
from etpnav_tpu.models import clip_vit as jclip
from etpnav_tpu.models import convert as jconvert
from etpnav_tpu.models import depth_resnet as jdepth
from etpnav_tpu_torch import config as C
from etpnav_tpu_torch.models import clip_vit, depth_resnet, planner, waypoint
from etpnav_tpu_torch.models import convert
from test_encoders import _TorchDepthEncoder, _torch_to_ref_state_dict
from test_released_layout_roundtrip import CFG as JCFG
from test_released_layout_roundtrip import WCFG as JWCFG
from test_released_layout_roundtrip import TorchNavCMT, TorchTRM, _inputs

torch.set_num_threads(2)

ATOL = 3e-5          # planner, waypoint (test_released_layout_roundtrip)
DEPTH_ATOL = 5e-5    # depth trunk (test_encoders)


def port_cfg(cls, jax_cfg):
    """The port's config section with the JAX section's values."""
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


PCFG = port_cfg(C.PlannerConfig, JCFG)
WCFG = port_cfg(C.WaypointConfig, JWCFG)
DCFG = C.DepthEncoderConfig(input_size=32, baseplanes=8, ngroups=4,
                            layers=(1, 1, 1, 1), output_size=16)
CLIP_CFG = C.ClipConfig(image_size=32, patch_size=16, width=64, layers=2,
                        heads=4, output_dim=32)


def seed_params(model: nn.Module, seed: int) -> nn.Module:
    """Overwrite every parameter from a seeded numpy stream: norm scales
    near 1, biases and norm shifts ~0.1, conv kernels He-scaled, every
    other array std 0.02 (the scheme of the port's other tests)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                z = rng.standard_normal(tuple(p.shape))
                if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                    z = (1.0 + 0.1 * z) if name == "weight" else 0.1 * z
                elif isinstance(mod, nn.Conv2d):
                    z = z * np.sqrt(2.0 / np.prod(p.shape[1:]))
                elif p.ndim == 1:
                    z = 0.1 * z
                else:
                    z = 0.02 * z
                p.copy_(torch.from_numpy(z.astype(np.float32)))
    return model


def openai_clip_state_dict(cfg, seed: int) -> dict:
    """Seeded tensors under the openai CLIP `visual.*` names and shapes
    (clip/model.py VisionTransformer)."""
    rng = np.random.default_rng(seed)
    w, ps = cfg.width, cfg.patch_size
    n_tok = (cfg.image_size // ps) ** 2 + 1

    def t(*shape, scale=0.02, offset=0.0):
        return torch.from_numpy(
            (offset + scale * rng.standard_normal(shape)).astype(np.float32))

    sd = {"visual.conv1.weight": t(w, 3, ps, ps),
          "visual.class_embedding": t(w),
          "visual.positional_embedding": t(n_tok, w),
          "visual.ln_pre.weight": t(w, scale=0.1, offset=1.0),
          "visual.ln_pre.bias": t(w, scale=0.1),
          "visual.ln_post.weight": t(w, scale=0.1, offset=1.0),
          "visual.ln_post.bias": t(w, scale=0.1),
          "visual.proj": t(w, cfg.output_dim)}
    for i in range(cfg.layers):
        b = f"visual.transformer.resblocks.{i}"
        sd.update({
            f"{b}.ln_1.weight": t(w, scale=0.1, offset=1.0),
            f"{b}.ln_1.bias": t(w, scale=0.1),
            f"{b}.attn.in_proj_weight": t(3 * w, w),
            f"{b}.attn.in_proj_bias": t(3 * w, scale=0.1),
            f"{b}.attn.out_proj.weight": t(w, w),
            f"{b}.attn.out_proj.bias": t(w, scale=0.1),
            f"{b}.ln_2.weight": t(w, scale=0.1, offset=1.0),
            f"{b}.ln_2.bias": t(w, scale=0.1),
            f"{b}.mlp.c_fc.weight": t(4 * w, w),
            f"{b}.mlp.c_fc.bias": t(4 * w, scale=0.1),
            f"{b}.mlp.c_proj.weight": t(w, 4 * w),
            f"{b}.mlp.c_proj.bias": t(w, scale=0.1)})
    # the text tower's keys sit beside the visual ones in the released file
    sd["token_embedding.weight"] = t(10, 8)
    return sd


def depth_state_dict(seed: int):
    model = seed_params(_TorchDepthEncoder(
        port_cfg(JaxDepthConfig, DCFG)).eval(), seed)
    return model, _torch_to_ref_state_dict(model, DCFG)


def assert_same_tree(ours, theirs, path="root"):
    """Same keys (lists item by item) and np.array_equal leaves."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict), path
        assert set(ours) == set(theirs), (path, sorted(ours), sorted(theirs))
        for k in theirs:
            assert_same_tree(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, (list, tuple)):
        assert isinstance(ours, (list, tuple)) and len(ours) == len(theirs)
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_tree(a, b, f"{path}[{i}]")
    else:
        a, b = np.asarray(ours), np.asarray(theirs)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape,
                                                           b.shape)
        assert np.array_equal(a, b), path


# ---------------------------------------------------------------------------
# planner: pretrain layout, bare and module-wrapped; fine-tune policy
# ---------------------------------------------------------------------------

def pretrain_state_dict(model, wrap=""):
    """Backbone under 'bert.', SAP head at top level, plus a pretrain
    head key the converter ignores (vlnbert_init.py:21-30)."""
    sd = {wrap + (k if k.startswith("global_sap_head.") else "bert." + k): v
          for k, v in model.state_dict().items()}
    sd[wrap + "mlm_head.predictions.bias"] = torch.zeros(PCFG.vocab_size)
    return sd


def port_planner(tree) -> planner.PlannerParams:
    params = planner.PlannerParams(PCFG)
    convert.load_jax_tree(params, tree)
    return params


def check_planner_forward(params, model, seed):
    """forward_txt + forward_navigation and forward_panorama of the port
    on the converted tree against the transcription."""
    inputs = _inputs(np.random.default_rng(seed))
    ids, txt_mask, gmap_img, step_ids, pos_fts, gmask, visited, dists = \
        inputs
    t = [torch.from_numpy(np.asarray(x)) for x in inputs]
    with torch.no_grad():
        theirs_txt = model.forward_txt(t[0], t[1])
        _, theirs = model.forward_navigation(theirs_txt, t[1], *t[2:])
        ours_txt = planner.forward_txt(params, PCFG, t[0], t[1])
        ours = planner.forward_navigation(
            params, PCFG, ours_txt, t[1], *t[2:])["global_logits"]
    live = gmask & ~visited
    np.testing.assert_allclose(ours.numpy()[live], theirs.numpy()[live],
                               atol=ATOL)
    assert np.isneginf(ours.numpy()[~gmask]).all()
    assert np.isneginf(ours.numpy()[visited & gmask]).all()

    g = np.random.default_rng(seed + 100)
    B, P = 2, 9
    rgb = g.standard_normal((B, P, PCFG.image_feat_size)).astype(np.float32)
    dep = g.standard_normal((B, P, PCFG.depth_feat_size)).astype(np.float32)
    loc = g.standard_normal((B, P, PCFG.angle_feat_size)).astype(np.float32)
    nav_types = g.integers(0, 2, (B, P)).astype(np.int64)
    vmask = np.ones((B, P), bool)
    vmask[0, 7:] = False
    pano = [torch.from_numpy(x) for x in (rgb, dep, loc, nav_types, vmask)]
    with torch.no_grad():
        theirs_p = model.forward_panorama(*pano).numpy()
        ours_p, _ = planner.forward_panorama(params, PCFG, *pano)
    np.testing.assert_allclose(ours_p.numpy()[vmask], theirs_p[vmask],
                               atol=ATOL)


@pytest.mark.parametrize("wrap", ["", "module."])
def test_pretrain_layout_matches_jax(wrap):
    model = seed_params(TorchNavCMT(JCFG).eval(), 1)
    sd = pretrain_state_dict(model, wrap)
    args = (PCFG.num_l_layers, PCFG.num_pano_layers, PCFG.num_x_layers)
    ours = convert.convert_planner(sd, *args)
    assert_same_tree(ours, jconvert.convert_planner(sd, *args))
    check_planner_forward(port_planner(ours), model, seed=1)


def test_finetune_policy_layout_matches_jax():
    """The released fine-tune checkpoint: {'state_dict': policy params}
    with the DDP-wrapped 'net.module.vln_bert.*' planner and the frozen
    encoders under net.depth_encoder.visual_encoder.* and
    net.rgb_encoder.model.visual.* (ss_trainer_ETP.py:74-83,211-212)."""
    model = seed_params(TorchNavCMT(JCFG).eval(), 2)
    _, depth_sd = depth_state_dict(3)
    clip_sd = openai_clip_state_dict(CLIP_CFG, 4)
    policy = {f"net.module.vln_bert.{k}": v
              for k, v in model.state_dict().items()}
    policy.update({f"net.depth_encoder.visual_encoder.{k}":
                   torch.from_numpy(np.asarray(v))
                   for k, v in depth_sd.items()})
    policy.update({f"net.rgb_encoder.model.{k}": v
                   for k, v in clip_sd.items()})
    wrapped = {"state_dict": policy, "iteration": 12000}
    ours = convert.convert_full_policy(wrapped, planner_cfg=PCFG,
                                       clip_cfg=CLIP_CFG, depth_cfg=DCFG)
    theirs = jconvert.convert_full_policy(
        wrapped, planner_cfg=JCFG, clip_cfg=port_cfg(
            jclip.ClipConfig, CLIP_CFG),
        depth_cfg=port_cfg(JaxDepthConfig, DCFG))
    assert set(ours) == set(theirs) == {"planner", "depth", "clip"}
    assert_same_tree(ours, theirs)
    check_planner_forward(port_planner(ours["planner"]), model, seed=2)


def test_converter_and_strict_load_raise_on_key_faults():
    model = seed_params(TorchNavCMT(JCFG).eval(), 5)
    sd = pretrain_state_dict(model)
    args = (PCFG.num_l_layers, PCFG.num_pano_layers, PCFG.num_x_layers)
    missing = dict(sd)
    del missing["bert.global_encoder.gmap_pos_embeddings.1.bias"]
    with pytest.raises(KeyError):
        convert.convert_planner(missing, *args)
    # an optional layer the file lacks leaves the module's parameter
    # without a key: the strict walk refuses it
    no_sprel = {k: v for k, v in sd.items() if "sprel_linear" not in k}
    with pytest.raises(KeyError, match="sprel_linear"):
        port_planner(convert.convert_planner(no_sprel, *args))
    extra = convert.convert_planner(sd, *args)
    extra["global_encoder"]["bogus"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="bogus"):
        port_planner(extra)


# ---------------------------------------------------------------------------
# waypoint predictor, CLIP towers, depth trunk
# ---------------------------------------------------------------------------

def test_waypoint_layout_matches_jax():
    model = seed_params(TorchTRM(JWCFG).eval(), 6)
    sd = {f"module.predictor.{k}": v for k, v in model.state_dict().items()}
    ours = convert.convert_waypoint(sd, WCFG.num_layers)
    assert_same_tree(ours, jconvert.convert_waypoint(sd, WCFG.num_layers))
    params = waypoint.WaypointParams(WCFG)
    convert.load_jax_tree(params, ours)
    dep = np.random.default_rng(6).standard_normal(
        (3 * 12,) + WCFG.depth_feat_shape).astype(np.float32)
    with torch.no_grad():
        theirs = model(torch.from_numpy(dep)).numpy()
        got = waypoint.waypoint_heatmap(params, WCFG, torch.from_numpy(
            dep.reshape((3, 12) + WCFG.depth_feat_shape))).numpy()
    np.testing.assert_allclose(got, theirs, atol=ATOL)


@pytest.mark.parametrize("visual_only", [False, True])
def test_openai_clip_layout_matches_jax(visual_only):
    sd = openai_clip_state_dict(CLIP_CFG, 7)
    if visual_only:
        sd = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}
    ours = clip_vit.convert_openai_clip(sd, CLIP_CFG)
    assert_same_tree(ours, jclip.convert_openai_clip(
        sd, port_cfg(jclip.ClipConfig, CLIP_CFG)))
    params = clip_vit.ClipParams(CLIP_CFG)
    convert.load_jax_tree(params, ours)
    # the packed in_proj splits into q, k, v in that order
    w = sd[("" if visual_only else "visual.")
           + "transformer.resblocks.1.attn.in_proj_weight"]
    assert torch.equal(params.blocks[1].attn.v.weight, w[2 * 64:])


def test_hf_clip_layout_matches_jax():
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection
    cfg = CLIP_CFG
    model = seed_params(CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=cfg.width, intermediate_size=cfg.width * 4,
        num_hidden_layers=cfg.layers, num_attention_heads=cfg.heads,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        projection_dim=cfg.output_dim, hidden_act="quick_gelu",
        layer_norm_eps=cfg.layer_norm_eps)).eval(), 8)
    sd = model.state_dict()
    ours = clip_vit.convert_hf_clip_vision(sd, cfg)
    assert_same_tree(ours, jclip.convert_hf_clip_vision(
        sd, port_cfg(jclip.ClipConfig, cfg)))


def test_ddppo_depth_layout_matches_jax():
    model, sd = depth_state_dict(9)
    ours = depth_resnet.convert_ddppo_depth(sd, DCFG)
    assert_same_tree(ours, jdepth.convert_ddppo_depth(
        sd, port_cfg(JaxDepthConfig, DCFG)))
    params = depth_resnet.DepthParams(DCFG)
    convert.load_jax_tree(params, ours)
    # OIHW -> HWIO (tree) -> OIHW (module): exact
    assert torch.equal(params.stem_conv.weight, model.stem[0].weight)
    assert torch.equal(params.layer3[0].conv2.weight,
                       model.blocks[2].convs[3].weight)
    assert torch.equal(params.compression_conv.weight,
                       model.compression[0].weight)
    depth = np.random.default_rng(9).random(
        (2, DCFG.input_size, DCFG.input_size, 1)).astype(np.float32)
    with torch.no_grad():
        got = depth_resnet.encode_depth(params, DCFG, torch.from_numpy(depth),
                                        dtype=torch.float32).numpy()
        theirs = model(torch.from_numpy(depth.transpose(0, 3, 1, 2))
                       ).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, theirs, atol=DEPTH_ATOL)


def test_hf_bert_encoder_tree_matches_jax():
    from transformers import BertConfig, BertModel
    model = seed_params(BertModel(BertConfig(
        vocab_size=PCFG.vocab_size, hidden_size=PCFG.hidden_size,
        num_hidden_layers=PCFG.num_l_layers,
        num_attention_heads=PCFG.num_heads,
        intermediate_size=PCFG.intermediate_size,
        max_position_embeddings=PCFG.max_position_embeddings),
        add_pooling_layer=False).eval(), 10)
    sd = {"bert." + k: v for k, v in model.state_dict().items()}
    ours = convert.convert_hf_bert_encoder(sd, PCFG.num_l_layers)
    assert_same_tree(ours, jconvert.convert_hf_bert_encoder(
        sd, PCFG.num_l_layers))
