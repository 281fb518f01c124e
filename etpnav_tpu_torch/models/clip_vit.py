"""CLIP ViT-B/32 image tower (counterpart of
`etpnav_tpu/models/clip_vit.py`).

The CLIP normalisation is folded into the patch-embedding matmul, which
runs on the raw uint8 patches; the last transformer block computes the
class-token row only (the image embedding reads nothing else). The
tower's attention runs through K-ATT: blocks 1..L-1 read q/k/v in the
natural projection layout, the last block is the Lq=1 cls-row case. With
`ClipConfig.use_fused_block` the attention half of blocks 1..L-1 is one
K-PRENORM op instead (`ops/fused_prenorm.py`): 11 per call at ViT-B/32
depth; the MLP half and the cls-row last block are unchanged.

`encode_image` takes images already normalised (`preprocess_rgb`), the
unfolded path the HF golden checks. The converters take the openai
`visual.*` state dict and HF's CLIPVisionModelWithProjection to the JAX
package's tree layout (`models/convert.py`), where the patch conv's
(width, 3, ps, ps) kernel becomes the (ps*ps*3, width) matrix in
`_patchify`'s (ps, ps, 3) row-major order.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from etpnav_tpu_torch.config import ClipConfig
from etpnav_tpu_torch.models.tree import (
    split_in_proj,
    stack_layers,
    to_numpy,
)
from etpnav_tpu_torch.ops.attention import MHA, mha
from etpnav_tpu_torch.ops.basic import (
    LayerNorm,
    Linear,
    matmul_f32,
    quick_gelu,
)
from etpnav_tpu_torch.ops.fused_prenorm import prenorm_attention
from etpnav_tpu_torch.parallel import tensor_parallel

# CLIP preprocessing constants (resnet_encoders.py:264-267)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class ClipBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MHA(width)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = Linear(width, width * 4)
        self.mlp_proj = Linear(width * 4, width)


class ClipParams(nn.Module):
    """patch_embed (ps*ps*3, width), class_embedding (width,),
    positional_embedding (P+1, width) and proj (width, output_dim) keep
    the JAX package's layouts."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = nn.Parameter(
            torch.zeros(cfg.patch_size * cfg.patch_size * 3, cfg.width))
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(n_patches + 1, cfg.width))
        self.ln_pre = LayerNorm(cfg.width)
        self.blocks = nn.ModuleList(ClipBlock(cfg.width)
                                    for _ in range(cfg.layers))
        self.ln_post = LayerNorm(cfg.width)
        self.proj = nn.Parameter(torch.zeros(cfg.width, cfg.output_dim))


def preprocess_rgb(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized fp32 (ConvertImageDtype+Normalize,
    resnet_encoders.py:263-267)."""
    dev = rgb_uint8.device
    x = rgb_uint8.to(torch.float32) / 255.0
    return ((x - torch.from_numpy(CLIP_MEAN).to(dev))
            / torch.from_numpy(CLIP_STD).to(dev))


def _patchify(images: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, P, ps*ps*C), row-major patch layout, in the
    input dtype."""
    B, H, W, C = images.shape
    gh, gw = H // ps, W // ps
    x = images.reshape(B, gh, ps, gw, ps, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, ps * ps * C)


def _mlp(bp: ClipBlock, h: torch.Tensor, eps: float) -> torch.Tensor:
    m = bp.ln_2(h, eps)
    m = quick_gelu(bp.mlp_fc(m))
    return h + bp.mlp_proj(m)


def _trunk(params: ClipParams, cfg: ClipConfig, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """Patch embeddings (B, P, width) -> (B, output_dim) fp32."""
    B = x.shape[0]
    eps = cfg.layer_norm_eps
    cls = params.class_embedding.to(dtype)[None, None, :].expand(
        B, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + params.positional_embedding.to(dtype)[None]
    x = params.ln_pre(x, eps)
    for bp in params.blocks[:-1]:
        if cfg.use_fused_block:
            # K-PRENORM takes whole weights: split ones are gathered and
            # the block runs replicated (XLA's way with a custom call)
            x = prenorm_attention(x, bp.ln_1, tensor_parallel.gathered(
                bp.attn), cfg.heads, eps)
        else:
            a = bp.ln_1(x, eps)
            x = x + mha(bp.attn, a, a, cfg.heads)
        x = _mlp(bp, x, eps)
    # last block, cls row only (identical math for that row)
    last = params.blocks[-1]
    a = last.ln_1(x, eps)
    h = _mlp(last, x[:, :1] + mha(last.attn, a[:, :1], a, cfg.heads), eps)
    cls_out = params.ln_post(h[:, 0], eps)
    return matmul_f32(cls_out, params.proj.to(dtype))


def encode_image(params: ClipParams, cfg: ClipConfig, images: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """images (B, H, W, 3) normalized fp32 -> (B, output_dim) fp32: the
    patch product taken in fp32 and rounded once to `dtype`, as
    `encode_image_uint8`'s."""
    x = _patchify(images, cfg.patch_size).to(dtype)
    x = matmul_f32(x, params.patch_embed.to(dtype)).to(dtype)
    return _trunk(params, cfg, x, dtype)


def fold_vectors(patch_size: int, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(s, t), the fp32 (ps*ps*3,) vectors of the CLIP normalisation on
    a flattened raw patch, n = p * s + t, on `device`."""
    n = patch_size * patch_size
    s = torch.from_numpy(np.tile(1.0 / (255.0 * CLIP_STD), n)).to(device)
    t = torch.from_numpy(np.tile(-CLIP_MEAN / CLIP_STD, n)).to(device)
    return s, t


def encode_image_uint8(params: ClipParams, cfg: ClipConfig,
                       rgb_uint8: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16,
                       fold: Optional[Tuple[torch.Tensor, torch.Tensor]]
                       = None) -> torch.Tensor:
    """(B, H, W, 3) raw uint8 -> (B, output_dim) fp32, with the CLIP
    normalisation folded into the patch matmul: n @ W = p @ (s*W) + t @ W.
    The fold happens in fp32 and then casts to `dtype`; the patch product
    is taken in fp32, the fp32 fold bias added, and rounded once. `fold`
    is `fold_vectors` on the images' device, made by the caller once
    (an upload from pageable memory waits for the device, and a CUDA
    graph cannot capture it); without it they are uploaded here."""
    ps = cfg.patch_size
    s, t = fold if fold is not None else fold_vectors(ps, rgb_uint8.device)
    w = params.patch_embed.float()
    w_folded = (s[:, None] * w).to(dtype)
    b_folded = torch.matmul(t, w)
    x = _patchify(rgb_uint8, ps).to(dtype)
    x = matmul_f32(x, w_folded, b_folded).to(dtype)
    return _trunk(params, cfg, x, dtype)


# ---------------------------------------------------------------------------
# converters (released layouts -> the JAX package's tree layout)
# ---------------------------------------------------------------------------

def _patch_matrix(conv: np.ndarray) -> np.ndarray:
    """(width, 3, ps, ps) conv kernel -> (ps*ps*3, width) in `_patchify`'s
    (ps, ps, 3) row-major order."""
    return conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0])


def convert_openai_clip(state_dict: Mapping, cfg: ClipConfig) -> dict:
    """openai clip state_dict (`visual.*` keys, or the tower's own) -> the
    CLIP tree; each block's packed in_proj splits into q/k/v."""
    sd = {k[len("visual."):]: to_numpy(v) for k, v in state_dict.items()
          if k.startswith("visual.")}
    if not sd:  # already visual-only
        sd = {k: to_numpy(v) for k, v in state_dict.items()}

    def ln(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    def lin(key):
        return {"w": sd[f"{key}.weight"].T, "b": sd[f"{key}.bias"]}

    blocks = []
    for i in range(cfg.layers):
        b = f"transformer.resblocks.{i}"
        attn = split_in_proj(sd[f"{b}.attn.in_proj_weight"],
                             sd[f"{b}.attn.in_proj_bias"])
        attn["o"] = lin(f"{b}.attn.out_proj")
        blocks.append({
            "ln_1": ln(f"{b}.ln_1"),
            "attn": attn,
            "ln_2": ln(f"{b}.ln_2"),
            "mlp_fc": lin(f"{b}.mlp.c_fc"),
            "mlp_proj": lin(f"{b}.mlp.c_proj"),
        })
    return {
        "patch_embed": _patch_matrix(sd["conv1.weight"]),
        "class_embedding": sd["class_embedding"],
        "positional_embedding": sd["positional_embedding"],
        "ln_pre": ln("ln_pre"),
        "blocks": stack_layers(blocks),
        "ln_post": ln("ln_post"),
        "proj": sd["proj"],
    }


def convert_hf_clip_vision(state_dict: Mapping, cfg: ClipConfig) -> dict:
    """HF CLIPVisionModelWithProjection state_dict -> the CLIP tree."""
    sd = {k: to_numpy(v) for k, v in state_dict.items()}
    pre = "vision_model."

    def lin(key):
        return {"w": sd[f"{key}.weight"].T, "b": sd[f"{key}.bias"]}

    def ln(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    blocks = []
    for i in range(cfg.layers):
        b = f"{pre}encoder.layers.{i}"
        blocks.append({
            "ln_1": ln(f"{b}.layer_norm1"),
            "attn": {
                "q": lin(f"{b}.self_attn.q_proj"),
                "k": lin(f"{b}.self_attn.k_proj"),
                "v": lin(f"{b}.self_attn.v_proj"),
                "o": lin(f"{b}.self_attn.out_proj"),
            },
            "ln_2": ln(f"{b}.layer_norm2"),
            "mlp_fc": lin(f"{b}.mlp.fc1"),
            "mlp_proj": lin(f"{b}.mlp.fc2"),
        })
    return {
        "patch_embed": _patch_matrix(
            sd[f"{pre}embeddings.patch_embedding.weight"]),
        "class_embedding": sd[f"{pre}embeddings.class_embedding"],
        "positional_embedding":
            sd[f"{pre}embeddings.position_embedding.weight"],
        # HF's attribute name is spelled so
        "ln_pre": ln(f"{pre}pre_layrnorm"),
        "blocks": stack_layers(blocks),
        "ln_post": ln(f"{pre}post_layernorm"),
        "proj": sd["visual_projection.weight"].T,
    }
