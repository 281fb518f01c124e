"""Released PyTorch checkpoints and JAX parameter trees -> the port's
modules.

Two steps, with one tree format between them: nested dicts of numpy
arrays laid out as the JAX package's parameter trees (dense `w` (in,
out), conv kernels HWIO, a stack's layers on a leading axis, the depth
trunk's blocks in a list).

1. The released-checkpoint converters (counterparts of
   `etpnav_tpu/models/convert.py`; CLIP's and the depth trunk's are in
   `clip_vit.py` and `depth_resnet.py`) turn a PyTorch state dict in the
   released ETPNav layouts into such a tree, equal leaf by leaf to the
   JAX converter's:
   - pretrain/fine-tune planner checkpoints with `module.` / `net.` /
     `vln_bert.` / `bert.` prefixes (key surgery of vlnbert_init.py:21-30
     and ss_trainer_ETP.py:226-236), stripped iteratively;
   - the waypoint predictor (`check_cwp_bestdist_hfov90`, TRM_net.py
     layout under `predictor.`);
   - the fine-tune policy that owns the frozen encoders
     (`{'state_dict': {'net.module.vln_bert.*', ...}}`);
   - HF `BertModel` / `XLMRobertaModel` encoders (the goldens);
   - PREVALENT's `pytorch_model.bin` into the recurrent VLN-BERT
     (`convert_rec_vlnbert`, which loads the port's module in place).
   Linear weights go from torch (out, in) to the tree's (in, out).
2. `load_jax_tree` copies a tree into a port module;
   `agent_params_from_jax` takes the JAX `AgentParams` as nested dicts
   (or the NamedTuple) of numpy arrays — no JAX object crosses over —
   and returns a loaded `Agent`, `pretrain_params_from_jax` takes
   the tree of the JAX `init_pretrain_params` and returns loaded
   `PretrainParams`, and `rec_vlnbert_params_from_jax`,
   `cma_params_from_jax` and `instruction_encoder_from_jax` do the same
   for the legacy DAgger policies, and `imagenet_resnet_params_from_jax`
   for the legacy ImageNet ResNet-50 RGB encoder:

- dense `w` goes from (in, out) to PyTorch's (out, in);
- convolution kernels go from HWIO to OIHW;
- a stack stored on a leading layer axis is split over the modules of
  an `nn.ModuleList` (a list, as the depth trunk's layers are, is taken
  item by item);
- every other array (CLIP's patch/class/positional embeddings and
  projection, embedding tables) is copied as it is.

The walk is strict: a key of the tree with no parameter, or a parameter
with no key, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from etpnav_tpu_torch.config import ExperimentConfig
from etpnav_tpu_torch.models.depth_resnet import Conv, GroupNorm
from etpnav_tpu_torch.models.tree import (
    split_in_proj,
    stack_layers,
    to_numpy,
)
from etpnav_tpu_torch.ops.basic import LayerNorm, Linear
from etpnav_tpu_torch.training.agent import Agent, AgentParams


def _as_dict(tree: Any) -> Mapping:
    return tree._asdict() if hasattr(tree, "_asdict") else tree


def _layer(tree: Any, i: int) -> Any:
    """Layer i of a stacked tree (leading axis) or of a list."""
    if isinstance(tree, (list, tuple)):
        return tree[i]
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _copy(p: torch.Tensor, value: np.ndarray, name: str) -> None:
    value = np.array(value, np.float32)     # a writable copy
    if tuple(value.shape) != tuple(p.shape):
        raise ValueError(f"{name}: shape {value.shape} != {tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(torch.from_numpy(value))


def load_jax_tree(module: nn.Module, tree: Any, name: str = "") -> None:
    """Copy a JAX parameter (sub)tree into `module`, in place."""
    tree = _as_dict(tree)
    if isinstance(module, Linear):
        _copy(module.weight, np.asarray(tree["w"]).T, f"{name}.w")
        _copy(module.bias, tree["b"], f"{name}.b")
        return
    if isinstance(module, (LayerNorm, GroupNorm)):
        _copy(module.weight, tree["scale"], f"{name}.scale")
        _copy(module.bias, tree["bias"], f"{name}.bias")
        return
    if isinstance(module, Conv):
        _copy(module.weight, np.asarray(tree["w"]).transpose(3, 2, 0, 1),
              f"{name}.w")
        return
    if isinstance(module, nn.ModuleList):
        for i, sub in enumerate(module):
            load_jax_tree(sub, _layer(tree, i), f"{name}[{i}]")
        return
    params = dict(module.named_parameters(recurse=False))
    children = dict(module.named_children())
    want = set(params) | set(children)
    if set(tree) != want:
        raise KeyError(f"{name or 'root'}: tree keys {sorted(tree)} != "
                       f"module keys {sorted(want)}")
    for key, p in params.items():
        _copy(p, tree[key], f"{name}.{key}")
    for key, child in children.items():
        load_jax_tree(child, tree[key], f"{name}.{key}")


def agent_params_from_jax(tree: Any, cfg: ExperimentConfig, *,
                          device="cuda") -> Agent:
    """JAX `AgentParams` as numpy -> a loaded `Agent` on `device`."""
    params = AgentParams(cfg)
    load_jax_tree(params, tree)
    return Agent(cfg, params, device=device)


def rec_vlnbert_params_from_jax(tree: Any, cfg):
    """The JAX `rec_vlnbert.init_params` tree as numpy -> loaded
    `RecVLNBertParams` (on the CPU) for `cfg` (a `RecVLNBertConfig`)."""
    from etpnav_tpu_torch.models.rec_vlnbert import RecVLNBertParams
    params = RecVLNBertParams(cfg)
    load_jax_tree(params, tree)
    return params


def cma_params_from_jax(tree: Any, cfg):
    """The JAX `cma.init_cma_params` tree as numpy -> loaded `CMAParams`
    (on the CPU) for `cfg` (a `CMAConfig`)."""
    from etpnav_tpu_torch.models.cma import CMAParams
    params = CMAParams(cfg)
    load_jax_tree(params, tree)
    return params


def instruction_encoder_from_jax(tree: Any, cfg):
    """The JAX `cma.init_instruction_encoder` tree as numpy -> loaded
    `InstructionEncoderParams` for `cfg` (an `InstructionEncoderConfig`)."""
    from etpnav_tpu_torch.models.cma import InstructionEncoderParams
    params = InstructionEncoderParams(cfg)
    load_jax_tree(params, tree)
    return params


def pretrain_params_from_jax(tree: Any, cfg: ExperimentConfig,
                             tasks=None):
    """The JAX `init_pretrain_params` tree as numpy -> `PretrainParams`
    (on the CPU) for `tasks` (default `cfg.pretrain.tasks`); strict, so a
    head of the tree without a task, or a task without its head,
    raises."""
    from etpnav_tpu_torch.training.pretrain import PretrainParams
    tasks = cfg.pretrain.tasks if tasks is None else tasks
    params = PretrainParams(cfg.planner, tasks, cfg.pretrain.image_prob_size)
    load_jax_tree(params, tree)
    return params


def imagenet_resnet_params_from_jax(tree: Any):
    """The JAX `init_imagenet_resnet_params` tree (or the tree of either
    package's `convert_torchvision_resnet50`) as numpy ->
    `ImagenetResNetParams` (on the CPU); the spatial embeddings are
    there when the tree has them."""
    from etpnav_tpu_torch.models.imagenet_resnet import ImagenetResNetParams
    params = ImagenetResNetParams(
        spatial_output="spatial_embeddings" in _as_dict(tree))
    load_jax_tree(params, tree)
    return params


# ---------------------------------------------------------------------------
# released PyTorch checkpoints -> trees
# ---------------------------------------------------------------------------

def strip_prefixes(state_dict: Mapping, prefixes=("module.", "net.",
                                                  "vln_bert.", "bert.")
                   ) -> Dict[str, np.ndarray]:
    """Normalize checkpoint keys: iteratively strip known wrapper prefixes
    (DDP 'module.', policy 'net.'/'vln_bert.', pretrain 'bert.')."""
    out = {}
    for k, v in state_dict.items():
        changed = True
        while changed:
            changed = False
            for p in prefixes:
                if k.startswith(p):
                    k = k[len(p):]
                    changed = True
        out[k] = to_numpy(v)
    return out


def _linear(sd, key):
    return {"w": sd[f"{key}.weight"].T, "b": sd[f"{key}.bias"]}


def _ln(sd, key):
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _attn_block(sd, base, out_base):
    """BertSelfAttention + BertSelfOutput -> an AttentionBlock tree."""
    return {
        "attn": {
            "q": _linear(sd, f"{base}.query"),
            "k": _linear(sd, f"{base}.key"),
            "v": _linear(sd, f"{base}.value"),
        },
        "out": {
            "dense": _linear(sd, f"{out_base}.dense"),
            "ln": _ln(sd, f"{out_base}.LayerNorm"),
        },
    }


def _ffn(sd, inter_key, out_key):
    return {
        "intermediate": _linear(sd, f"{inter_key}.dense"),
        "output": {
            "dense": _linear(sd, f"{out_key}.dense"),
            "ln": _ln(sd, f"{out_key}.LayerNorm"),
        },
    }


def _bert_layer(sd, base):
    return {
        "attention": _attn_block(sd, f"{base}.attention.self",
                                 f"{base}.attention.output"),
        "ffn": _ffn(sd, f"{base}.intermediate", f"{base}.output"),
    }


def _prenorm_layer(sd, base):
    """nn.TransformerEncoderLayer(norm_first=True) -> a pre-norm layer
    tree, the packed q/k/v split."""
    attn = split_in_proj(sd[f"{base}.self_attn.in_proj_weight"],
                         sd[f"{base}.self_attn.in_proj_bias"])
    attn["o"] = _linear(sd, f"{base}.self_attn.out_proj")
    return {
        "attn": attn,
        "norm1": _ln(sd, f"{base}.norm1"),
        "norm2": _ln(sd, f"{base}.norm2"),
        "linear1": _linear(sd, f"{base}.linear1"),
        "linear2": _linear(sd, f"{base}.linear2"),
    }


def _embeddings(sd):
    return {
        "word_embeddings": sd["embeddings.word_embeddings.weight"],
        "position_embeddings": sd["embeddings.position_embeddings.weight"],
        "token_type_embeddings":
            sd["embeddings.token_type_embeddings.weight"],
        "ln": _ln(sd, "embeddings.LayerNorm"),
    }


def _x_layer(sd, base):
    return {
        "visual_attention": _attn_block(
            sd, f"{base}.visual_attention.att",
            f"{base}.visual_attention.output"),
        "visn_self_att": _attn_block(sd, f"{base}.visn_self_att.self",
                                     f"{base}.visn_self_att.output"),
        "visn_ffn": _ffn(sd, f"{base}.visn_inter", f"{base}.visn_output"),
    }


def convert_planner(state_dict: Mapping, num_l_layers: int = 9,
                    num_pano_layers: int = 2, num_x_layers: int = 4
                    ) -> dict:
    """ETPNav planner state_dict (GlocalTextPathNavCMT names,
    vilmodel_cmt.py:663-750) -> the planner tree. Keys other than the
    planner's (the pretrain heads) are ignored; `dep_linear` and
    `sprel_linear` are converted when present."""
    sd = strip_prefixes(state_dict)
    ie = "img_embeddings"
    params = {
        "embeddings": _embeddings(sd),
        "lang_encoder": stack_layers([
            _bert_layer(sd, f"lang_encoder.layer.{i}")
            for i in range(num_l_layers)]),
        "img_embeddings": {
            "img_linear": _linear(sd, f"{ie}.img_linear"),
            "img_ln": _ln(sd, f"{ie}.img_layer_norm"),
            "loc_linear": _linear(sd, f"{ie}.loc_linear"),
            "loc_ln": _ln(sd, f"{ie}.loc_layer_norm"),
            "nav_type_embedding": sd[f"{ie}.nav_type_embedding.weight"],
            "ln": _ln(sd, f"{ie}.layer_norm"),
            "pano_encoder": {
                "layers": stack_layers([
                    _prenorm_layer(sd, f"{ie}.pano_encoder.layers.{i}")
                    for i in range(num_pano_layers)]),
                "final_ln": _ln(sd, f"{ie}.pano_encoder.norm"),
            },
        },
        "global_encoder": {
            # nn.Sequential(Linear, LayerNorm): indices stand for names
            "gmap_pos_embeddings": {
                "dense": _linear(sd, "global_encoder.gmap_pos_embeddings.0"),
                "ln": _ln(sd, "global_encoder.gmap_pos_embeddings.1"),
            },
            "gmap_step_embeddings":
                sd["global_encoder.gmap_step_embeddings.weight"],
            "encoder": stack_layers([
                _x_layer(sd, f"global_encoder.encoder.x_layers.{i}")
                for i in range(num_x_layers)]),
        },
        # nn.Sequential(Linear, ReLU, LayerNorm, Dropout, Linear)
        "global_sap_head": {
            "dense1": _linear(sd, "global_sap_head.net.0"),
            "ln": _ln(sd, "global_sap_head.net.2"),
            "dense2": _linear(sd, "global_sap_head.net.4"),
        },
    }
    if f"{ie}.dep_linear.weight" in sd:
        params["img_embeddings"]["dep_linear"] = _linear(
            sd, f"{ie}.dep_linear")
        params["img_embeddings"]["dep_ln"] = _ln(sd, f"{ie}.dep_layer_norm")
    if "global_encoder.sprel_linear.weight" in sd:
        params["global_encoder"]["sprel_linear"] = _linear(
            sd, "global_encoder.sprel_linear")
    return params


def convert_waypoint(state_dict: Mapping, num_layers: int = 2) -> dict:
    """Waypoint predictor checkpoint -> the waypoint tree (TRM_net.py
    layout; the trainer strips 'predictor.' prefixes,
    ss_trainer_ETP.py:196-202). `visual_fc_depth.1` and
    `vis_classifier.{0,2}` are nn.Sequential indices."""
    sd = strip_prefixes(state_dict, ("module.", "predictor."))
    return {
        "visual_fc_depth": _linear(sd, "visual_fc_depth.1"),
        "waypoint_trm": stack_layers([
            _bert_layer(sd, f"waypoint_TRM.bert.encoder.layer.{i}")
            for i in range(num_layers)]),
        "vis_classifier": {
            "dense1": _linear(sd, "vis_classifier.0"),
            "dense2": _linear(sd, "vis_classifier.2"),
        },
    }


def convert_full_policy(state_dict: Mapping, planner_cfg=None,
                        clip_cfg=None, depth_cfg=None) -> dict:
    """Released *fine-tune* checkpoint (ss_trainer_ETP.py:74-83 layout:
    {'state_dict': policy params with net./module. prefixes}) -> dict of
    {'planner', 'clip', 'depth'} trees. The policy owns the frozen
    encoders as submodules (Policy_ViewSelection_ETP.py:118-139):
    net.depth_encoder.visual_encoder.*, net.rgb_encoder.model.visual.*,
    net.vln_bert.*. The configs default to `r2r_config()`'s."""
    from etpnav_tpu_torch.config import r2r_config
    from etpnav_tpu_torch.models.clip_vit import convert_openai_clip
    from etpnav_tpu_torch.models.depth_resnet import convert_ddppo_depth

    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    # iterative strip: DDP-wrapped policies save 'net.module.vln_bert.*'
    # (ss_trainer_ETP.py:211-212 wraps policy.net in DDP)
    flat = strip_prefixes(state_dict, ("module.", "net."))

    def under(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}

    planner_sd = under("vln_bert.")
    depth_sd = under("depth_encoder.visual_encoder.")
    clip_sd = under("rgb_encoder.model.")
    pc = planner_cfg or r2r_config().planner
    out = {"planner": convert_planner(planner_sd, pc.num_l_layers,
                                      pc.num_pano_layers, pc.num_x_layers)}
    if depth_sd:
        out["depth"] = convert_ddppo_depth(
            depth_sd, depth_cfg or r2r_config().depth)
    if clip_sd:
        out["clip"] = convert_openai_clip(
            clip_sd, clip_cfg or r2r_config().clip)
    return out


def convert_rec_vlnbert(state_dict: Mapping, params: nn.Module,
                        la_layers: int = 9, vl_layers: int = 4) -> nn.Module:
    """PREVALENT `pytorch_model.bin` (the VLNBert layout of
    vlnbert_PREVALENT.py:362-381, loaded by the reference at
    vlnbert_init.py:10-18) -> the transformer of a `RecVLNBertParams`,
    loaded into `params` in place (and returned).

    Converts the embeddings, the la_layers language stack
    (`lalayer.{i}.*`), each LXRT layer's VISUAL branch
    (`addlayer.{i}.visual_attention/visn_self_att/visn_inter/
    visn_output`) and the pooler. The candidate-fusion projections have no
    reference counterpart and keep `params`' values. The dead lang-branch
    parameters inside each LXRTXLayer (lang_self_att/lang_inter/
    lang_output, initialised but never called, vlnbert_PREVALENT.py:296-298
    against :322-342) are ignored."""
    sd = strip_prefixes(state_dict)
    if len(params.lalayer) != la_layers or len(params.addlayer) != vl_layers:
        raise ValueError(f"params hold {len(params.lalayer)} + "
                         f"{len(params.addlayer)} layers, not {la_layers} + "
                         f"{vl_layers}")
    load_jax_tree(params.embeddings, _embeddings(sd), "embeddings")
    load_jax_tree(params.lalayer, stack_layers([
        _bert_layer(sd, f"lalayer.{i}") for i in range(la_layers)]),
        "lalayer")
    load_jax_tree(params.addlayer, stack_layers([{
        "cross": _attn_block(sd, f"addlayer.{i}.visual_attention.att",
                             f"addlayer.{i}.visual_attention.output"),
        "self": _attn_block(sd, f"addlayer.{i}.visn_self_att.self",
                            f"addlayer.{i}.visn_self_att.output"),
        "ffn": _ffn(sd, f"addlayer.{i}.visn_inter",
                    f"addlayer.{i}.visn_output"),
    } for i in range(vl_layers)]), "addlayer")
    load_jax_tree(params.pooler, _linear(sd, "pooler.dense"), "pooler")
    return params


def convert_hf_bert_encoder(state_dict: Mapping, num_layers: int) -> dict:
    """HF transformers BertModel / XLMRobertaModel state_dict -> the
    planner's `embeddings` and `lang_encoder` trees (the goldens)."""
    sd = strip_prefixes(state_dict, ("bert.",))
    return {"embeddings": _embeddings(sd),
            "lang_encoder": stack_layers([
                _bert_layer(sd, f"encoder.layer.{i}")
                for i in range(num_layers)])}
