"""DD-PPO depth encoder: habitat-style GroupNorm ResNet-50 (counterpart
of `etpnav_tpu/models/depth_resnet.py`).

Runs NCHW tensors through `F.conv2d` (weights OIHW); the public
`encode_depth` keeps the JAX package's NHWC layout at its input and
output. The NCHW view of the NHWC input is channels_last in memory, and
the convolutions keep that memory format. GroupNorm is the JAX package's
form, fp32 moments with the variance as E[x^2] - E[x]^2 on per-group
means, which `F.group_norm` does not compute the same way. With
`DepthEncoderConfig.use_fused_gn` every norm, with its ReLU and the
bottleneck's residual add, is one K-GN launch (`ops/fused_groupnorm.py`):
54 per call at R2R depth.

`convert_ddppo_depth` takes the released DD-PPO trunk to the JAX
package's tree layout (`models/convert.py`; kernels HWIO, which
`load_jax_tree` turns back to OIHW: an exact round trip).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from etpnav_tpu_torch.config import DepthEncoderConfig
from etpnav_tpu_torch.models.tree import to_numpy
from etpnav_tpu_torch.ops.fused_groupnorm import group_norm_fused


class Conv(nn.Module):
    """Bias-free conv weight, OIHW."""

    def __init__(self, k: int, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))

    def init_(self, generator: torch.Generator) -> None:
        _, c_in, k, _ = self.weight.shape
        with torch.no_grad():
            self.weight.normal_(generator=generator).mul_(
                math.sqrt(2.0 / (k * k * c_in)))


class GroupNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


def conv2d(params: Conv, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, params.weight.to(x.dtype), stride=stride,
                    padding=padding)


def group_norm(params: GroupNorm, x: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """NCHW GroupNorm, fp32 moments, E[x^2] - E[x]^2 on group means,
    applied as a per-channel affine; returns the input dtype."""
    B, C = x.shape[:2]
    cg = C // groups
    x32 = x.float()
    s1 = x32.sum((2, 3))                               # (B, C)
    s2 = x32.square().sum((2, 3))
    n = x.shape[2] * x.shape[3] * cg
    g1 = s1.reshape(B, groups, cg).sum(-1) / n         # group mean
    g2 = s2.reshape(B, groups, cg).sum(-1) / n         # group E[x^2]
    inv = torch.rsqrt(torch.clamp_min(g2 - g1.square(), 0.0) + eps)
    a = inv.repeat_interleave(cg, dim=1) * params.weight[None]
    b = params.bias[None] - g1.repeat_interleave(cg, dim=1) * a
    y = x32 * a[:, :, None, None] + b[:, :, None, None]
    return y.to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, planes: int, expansion: int,
                 has_down: bool):
        super().__init__()
        self.conv1 = Conv(1, c_in, planes)
        self.gn1 = GroupNorm(planes)
        self.conv2 = Conv(3, planes, planes)
        self.gn2 = GroupNorm(planes)
        self.conv3 = Conv(1, planes, planes * expansion)
        self.gn3 = GroupNorm(planes * expansion)
        if has_down:
            self.down_conv = Conv(1, c_in, planes * expansion)
            self.down_gn = GroupNorm(planes * expansion)


def _bottleneck(params: Bottleneck, x: torch.Tensor, stride: int,
                ngroups: int, fused_gn: bool = False) -> torch.Tensor:
    if fused_gn:
        h = group_norm_fused(params.gn1, conv2d(params.conv1, x), ngroups,
                             relu=True)
        h = group_norm_fused(params.gn2, conv2d(params.conv2, h, stride, 1),
                             ngroups, relu=True)
        if hasattr(params, "down_conv"):
            x = group_norm_fused(params.down_gn,
                                 conv2d(params.down_conv, x, stride), ngroups)
        # gn3 + residual add + ReLU in one launch
        return group_norm_fused(params.gn3, conv2d(params.conv3, h), ngroups,
                                relu=True, residual=x)
    h = F.relu(group_norm(params.gn1, conv2d(params.conv1, x), ngroups))
    h = F.relu(group_norm(params.gn2, conv2d(params.conv2, h, stride, 1),
                          ngroups))
    h = group_norm(params.gn3, conv2d(params.conv3, h), ngroups)
    if hasattr(params, "down_conv"):
        x = group_norm(params.down_gn, conv2d(params.down_conv, x, stride),
                       ngroups)
    return F.relu(h + x)


class DepthParams(nn.Module):
    def __init__(self, cfg: DepthEncoderConfig):
        super().__init__()
        bp, exp = cfg.baseplanes, cfg.expansion
        self.stem_conv = Conv(7, 1, bp)
        self.stem_gn = GroupNorm(bp)
        c_in = bp
        for li, blocks in enumerate(cfg.layers):
            planes = bp * (2 ** li)
            layer = nn.ModuleList()
            for bi in range(blocks):
                has_down = bi == 0 and (c_in != planes * exp or li > 0)
                layer.append(Bottleneck(c_in, planes, exp, has_down))
                c_in = planes * exp
            setattr(self, f"layer{li + 1}", layer)
        final_spatial = cfg.input_size // 32
        comp_channels = int(round(cfg.output_size / (final_spatial ** 2)))
        self.compression_conv = Conv(3, c_in, comp_channels)
        self.compression_gn = GroupNorm(comp_channels)


def encode_depth(params: DepthParams, cfg: DepthEncoderConfig,
                 depth: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """depth (B, H, W, 1) in [0,1] -> (B, s, s, C) fp32 spatial features
    (s = H/32; (4, 4, 128) at H=128)."""
    fused = cfg.use_fused_gn
    if fused:
        def gn_relu(p, x, g):
            return group_norm_fused(p, x, g, relu=True)
    else:
        def gn_relu(p, x, g):
            return F.relu(group_norm(p, x, g))
    x = depth.to(dtype).permute(0, 3, 1, 2)
    x = conv2d(params.stem_conv, x, 2, 3)
    x = gn_relu(params.stem_gn, x, cfg.ngroups)
    x = F.max_pool2d(x, 3, 2, 1)
    for li in range(4):
        stride = 1 if li == 0 else 2
        for bi, bparams in enumerate(getattr(params, f"layer{li + 1}")):
            x = _bottleneck(bparams, x, stride if bi == 0 else 1,
                            cfg.ngroups, fused_gn=fused)
    x = conv2d(params.compression_conv, x, 1, 1)
    x = gn_relu(params.compression_gn, x, 1)
    return x.permute(0, 2, 3, 1).float()


# ---------------------------------------------------------------------------
# converter (reference ddppo key layout)
# ---------------------------------------------------------------------------

def convert_ddppo_depth(state_dict: Mapping, cfg: DepthEncoderConfig
                        ) -> dict:
    """Keys as produced by resnet_encoders.py:40-47 surgery:
    backbone.conv1.weight, backbone.bn1.{weight,bias},
    backbone.layer{1-4}.{i}.convs.{0,3,6}.weight (convs),
    backbone.layer{1-4}.{i}.convs.{1,4,7}.{weight,bias} (group norms),
    backbone.layer{1-4}.{i}.downsample.{0,1}.*, compression.{0,1}.*.
    Torch conv OIHW -> HWIO."""
    sd = {k: to_numpy(v) for k, v in state_dict.items()}

    def conv(key):
        return {"w": sd[f"{key}.weight"].transpose(2, 3, 1, 0)}

    def gn(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    params = {
        "stem_conv": conv("backbone.conv1"),
        "stem_gn": gn("backbone.bn1"),
        "compression_conv": conv("compression.0"),
        "compression_gn": gn("compression.1"),
    }
    for li in range(1, 5):
        layer = []
        bi = 0
        while f"backbone.layer{li}.{bi}.convs.0.weight" in sd:
            base = f"backbone.layer{li}.{bi}"
            block = {
                "conv1": conv(f"{base}.convs.0"),
                "gn1": gn(f"{base}.convs.1"),
                "conv2": conv(f"{base}.convs.3"),
                "gn2": gn(f"{base}.convs.4"),
                "conv3": conv(f"{base}.convs.6"),
                "gn3": gn(f"{base}.convs.7"),
            }
            if f"{base}.downsample.0.weight" in sd:
                block["down_conv"] = conv(f"{base}.downsample.0")
                block["down_gn"] = gn(f"{base}.downsample.1")
            layer.append(block)
            bi += 1
        params[f"layer{li}"] = layer
    return params
