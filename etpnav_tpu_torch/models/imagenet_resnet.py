"""ImageNet ResNet-50 RGB encoder of the legacy CMA-era policies (the
port's counterpart of `etpnav_tpu/models/imagenet_resnet.py`).

Parity target: TorchVisionResNet50 (reference
vlnce_baselines/models/encoders/resnet_encoders.py:110-241): a frozen
torchvision resnet50 truncated after layer4, fed uint8 RGB scaled to
[0, 1] and ImageNet-normalised (resnet_encoders.py:182-186). With
spatial_output it appends an adaptive 4x4 average pool and a learned
16-slot x 64-d spatial embedding (resnet_encoders.py:163-236), giving
(B, 4, 4, 2112) in the JAX package's NHWC layout; without it, the raw
layer4 map (B, H/32, W/32, 2048).

The encoder is frozen, so BatchNorm's running statistics fold into a
per-channel affine at conversion (`convert_torchvision_resnet50`):
inference carries no BN state. Convolutions run NCHW with
channels_last memory, as the depth trunk's do; each is accumulated in
fp32 and rounded once to the encoder's dtype, as the JAX package's.
`models/convert.py::imagenet_resnet_params_from_jax` loads the JAX
package's parameter tree.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from etpnav_tpu_torch.models.depth_resnet import Conv, conv2d
from etpnav_tpu_torch.models.tree import to_numpy

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_LAYERS = (3, 4, 6, 3)          # torchvision resnet50
_EXPANSION = 4
SPATIAL_GRID = 4                # adaptive pool target (4, 4)
SPATIAL_EMBED_DIM = 64          # resnet_encoders.py:172


class Affine(nn.Module):
    """A folded batch norm: x * a + b per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.a = nn.Parameter(torch.ones(channels))
        self.b = nn.Parameter(torch.zeros(channels))

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.a.normal_(generator=generator).mul_(0.1).add_(1.0)
            self.b.normal_(generator=generator).mul_(0.1)


def _affine(params: Affine, x: torch.Tensor) -> torch.Tensor:
    """NCHW affine in fp32, returned in x's dtype."""
    return (x.float() * params.a[None, :, None, None]
            + params.b[None, :, None, None]).to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, planes: int, has_down: bool):
        super().__init__()
        self.conv1 = Conv(1, c_in, planes)
        self.bn1 = Affine(planes)
        self.conv2 = Conv(3, planes, planes)
        self.bn2 = Affine(planes)
        self.conv3 = Conv(1, planes, planes * _EXPANSION)
        self.bn3 = Affine(planes * _EXPANSION)
        if has_down:
            self.down_conv = Conv(1, c_in, planes * _EXPANSION)
            self.down_bn = Affine(planes * _EXPANSION)


class ImagenetResNetParams(nn.Module):
    def __init__(self, spatial_output: bool = True):
        super().__init__()
        self.stem_conv = Conv(7, 3, 64)
        self.stem_bn = Affine(64)
        c_in = 64
        for li, blocks in enumerate(_LAYERS):
            planes = 64 * (2 ** li)
            layer = []
            for bi in range(blocks):
                # layer1: channel jump; layer2-4: stride
                layer.append(Bottleneck(c_in, planes, has_down=bi == 0))
                c_in = planes * _EXPANSION
            setattr(self, f"layer{li + 1}", nn.ModuleList(layer))
        if spatial_output:
            self.spatial_embeddings = nn.Parameter(
                torch.zeros(SPATIAL_GRID * SPATIAL_GRID, SPATIAL_EMBED_DIM))


def init_imagenet_resnet_params(generator: torch.Generator,
                                spatial_output: bool = True
                                ) -> ImagenetResNetParams:
    """Random parameters from a seeded `torch.Generator`, with the JAX
    package's distributions (He-normal convs, affine a ~ 1 + 0.1 N,
    b ~ 0.1 N, embeddings N(0, 1))."""
    params = ImagenetResNetParams(spatial_output)
    for m in params.modules():
        if isinstance(m, (Conv, Affine)):
            m.init_(generator)
    if spatial_output:
        with torch.no_grad():
            params.spatial_embeddings.normal_(generator=generator)
    return params


def _bottleneck(params: Bottleneck, x: torch.Tensor,
                stride: int) -> torch.Tensor:
    h = F.relu(_affine(params.bn1, conv2d(params.conv1, x)))
    h = F.relu(_affine(params.bn2, conv2d(params.conv2, h, stride, 1)))
    h = _affine(params.bn3, conv2d(params.conv3, h))
    if hasattr(params, "down_conv"):
        x = _affine(params.down_bn, conv2d(params.down_conv, x, stride))
    return F.relu(h + x)


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """torch's adaptive_avg_pool2d on NHWC, with the JAX package's static
    bins: bin i covers rows [floor(i*H/out), ceil((i+1)*H/out)) (bins may
    overlap), each averaged in fp32 and returned in x's dtype."""
    B, H, W, C = x.shape
    x32 = x.float()
    rows = []
    for i in range(out):
        h0, h1 = (i * H) // out, -(-((i + 1) * H) // out)
        cols = []
        for j in range(out):
            w0, w1 = (j * W) // out, -(-((j + 1) * W) // out)
            cols.append(x32[:, h0:h1, w0:w1].mean(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1).to(x.dtype)       # (B, out, out, C)


def encode_imagenet_rgb(params: ImagenetResNetParams, rgb: torch.Tensor,
                        spatial_output: bool = True,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """rgb (B, H, W, 3) uint8 -> (B, 4, 4, 2112) spatial features, or the
    raw (B, H/32, W/32, 2048) layer4 map when spatial_output=False."""
    dev = rgb.device
    x = rgb.float() / 255.0
    x = ((x - torch.from_numpy(IMAGENET_MEAN).to(dev))
         / torch.from_numpy(IMAGENET_STD).to(dev)).to(dtype)
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_affine(params.stem_bn, conv2d(params.stem_conv, x, 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for li in range(4):
        stride = 1 if li == 0 else 2
        for bi, bparams in enumerate(getattr(params, f"layer{li + 1}")):
            x = _bottleneck(bparams, x, stride if bi == 0 else 1)
    x = x.permute(0, 2, 3, 1)
    if not spatial_output:
        return x.float()
    x = adaptive_avg_pool(x, SPATIAL_GRID)               # (B, 4, 4, 2048)
    # Reference quirk (resnet_encoders.py:222-233): the (16, 64) table is
    # `.view(1, -1, h, w)`-ed, i.e. read as a (64, 4, 4) channel-major
    # block, not one 64-d embedding per grid cell.
    emb = params.spatial_embeddings.reshape(
        SPATIAL_EMBED_DIM, SPATIAL_GRID, SPATIAL_GRID).permute(1, 2, 0)
    emb = emb[None].expand(x.shape[0], *emb.shape)
    return torch.cat([x.float(), emb.float()], dim=-1)


def convert_torchvision_resnet50(state_dict: Mapping, prefix: str = "",
                                 eps: float = 1e-5) -> dict:
    """A torchvision resnet50 state dict (conv1.weight, bn1.*,
    layer{1-4}.{i}.conv{1-3}.weight / bn{1-3}.* / downsample.{0,1}.*;
    the reference wraps these under `cnn.` beside
    spatial_embeddings.weight, resnet_encoders.py:158,172) -> the JAX
    package's tree layout as numpy (conv kernels HWIO; each BN folded to
    a = gamma / sqrt(var + eps), b = beta - mean * a), equal leaf by leaf
    to the JAX converter's. `models/convert.py::
    imagenet_resnet_params_from_jax` loads it."""
    sd = {k[len(prefix):]: to_numpy(v) for k, v in state_dict.items()
          if k.startswith(prefix)}

    def conv(key):
        return {"w": sd[f"{key}.weight"].transpose(2, 3, 1, 0)}

    def bn(key):
        gamma, beta = sd[f"{key}.weight"], sd[f"{key}.bias"]
        mean, var = sd[f"{key}.running_mean"], sd[f"{key}.running_var"]
        a = gamma / np.sqrt(var + eps)
        return {"a": a, "b": beta - mean * a}

    cnn = "cnn." if "cnn.conv1.weight" in sd else ""
    params = {"stem_conv": conv(f"{cnn}conv1"), "stem_bn": bn(f"{cnn}bn1")}
    for li in range(1, 5):
        layer = []
        bi = 0
        while f"{cnn}layer{li}.{bi}.conv1.weight" in sd:
            base = f"{cnn}layer{li}.{bi}"
            block = {
                "conv1": conv(f"{base}.conv1"), "bn1": bn(f"{base}.bn1"),
                "conv2": conv(f"{base}.conv2"), "bn2": bn(f"{base}.bn2"),
                "conv3": conv(f"{base}.conv3"), "bn3": bn(f"{base}.bn3"),
            }
            if f"{base}.downsample.0.weight" in sd:
                block["down_conv"] = conv(f"{base}.downsample.0")
                block["down_bn"] = bn(f"{base}.downsample.1")
            layer.append(block)
            bi += 1
        params[f"layer{li}"] = layer
    if "spatial_embeddings.weight" in sd:
        params["spatial_embeddings"] = sd["spatial_embeddings.weight"]
    return params
