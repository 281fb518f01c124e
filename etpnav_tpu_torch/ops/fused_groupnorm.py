"""K-GN: the one-pass GroupNorm kernel of the port, its wrapper and its
plain version.

Replaces the Pallas TPU kernel `group_norm_fused`
(`etpnav_tpu/ops/pallas_groupnorm.py`): GroupNorm with fp32 statistics,
the per-channel affine, an optional residual add and an optional ReLU, in
one launch with one rounding to x's dtype. The CUDA C++ source,
`csrc/groupnorm.cu`, says what bounds the kernel on an H100 and what its
design does about it.

Layout contract: x (B, C, H, W) channels_last, the layout of the depth
trunk's activations (its NHWC input viewed as NCHW, kept by the
convolutions); the residual has x's shape, dtype and strides, and the
output takes x's strides. scale and bias are the fp32 `GroupNorm`
parameters.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn as nn

from etpnav_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (wrapper) and calls of the plain version
group_norm_launches = cuda_build.LaunchCounter()
group_norm_plain_calls = cuda_build.LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
    i32, vp = ctypes.c_int, ctypes.c_void_p
    lib.etp_group_norm.argtypes = (
        [vp] * 5 + [i32] * 5 + [ctypes.c_float, i32, vp])
    lib.etp_group_norm.restype = ctypes.c_int


cuda_build.register_binder("groupnorm", _bind)


def group_norm_plain(params: nn.Module, x: torch.Tensor, groups: int,
                     eps: float = 1e-5, relu: bool = False,
                     residual: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The plain PyTorch version of K-GN, with the kernel's numerics: fp32
    mean and E[x^2] per group, inv = rsqrt(max(E[x^2] - mean^2, 0) + eps),
    a = inv*scale, b = bias - mean*a, y = x*a + b, + residual, ReLU, one
    rounding to x's dtype."""
    group_norm_plain_calls.add()
    B, C, H, W = x.shape
    cg = C // groups
    x32 = x.float()
    xg = x32.reshape(B, groups, cg * H * W)
    n = cg * H * W
    mean = xg.sum(-1) / n                                  # (B, G)
    ex2 = xg.square().sum(-1) / n
    inv = torch.rsqrt(torch.clamp_min(ex2 - mean.square(), 0.0) + eps)
    a = inv.repeat_interleave(cg, dim=1) * params.weight[None]
    b = params.bias[None] - mean.repeat_interleave(cg, dim=1) * a
    y = x32 * a[:, :, None, None] + b[:, :, None, None]
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def check_card_args(params: nn.Module, x: torch.Tensor, groups: int,
                    residual: Optional[torch.Tensor]) -> None:
    """Raise ValueError unless the kernel takes these operands: x a
    channels_last (B, C, H, W) float32 or bfloat16 tensor, C a multiple
    of `groups` and of 8 that divides 2048 (each thread of the kernel
    reads 8 channels, and 256 threads one pixel-aligned span), x and the
    residual 16-byte aligned, the residual of x's shape, dtype, device
    and strides, and fp32 contiguous (C,) parameters on x's device."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"group_norm_fused: needs (B, C, H, W) float32 or "
                         f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    C = x.shape[1]
    if C % groups:
        raise ValueError(f"group_norm_fused: {C} channels, {groups} groups")
    if C % 8 or 2048 % C:
        raise ValueError(f"group_norm_fused: built for 8 to 2048 channels "
                         f"dividing 2048, got {C}")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"group_norm_fused: {name} is not 16-byte "
                             "aligned")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"group_norm_fused: x with strides {x.stride()} is "
                         "not channels_last")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or residual.stride() != x.stride()):
        raise ValueError(f"group_norm_fused: residual {tuple(residual.shape)}"
                         f" {residual.dtype} strides {residual.stride()} on "
                         f"{residual.device} differs from x "
                         f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
    for name, p in (("weight", params.weight), ("bias", params.bias)):
        if (p.dtype != torch.float32 or p.device != x.device
                or tuple(p.shape) != (C,) or not p.is_contiguous()):
            raise ValueError(f"group_norm_fused: {name} must be contiguous "
                             f"float32 ({C},) on {x.device}, got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")


def group_norm_fused(params: nn.Module, x: torch.Tensor, groups: int,
                     eps: float = 1e-5, relu: bool = False,
                     residual: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """GroupNorm(x) (+ residual) (ReLU) in x's dtype and strides. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return group_norm_plain(params, x, groups, eps, relu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_fused: unsupported device {x.device}")
    check_card_args(params, x, groups, residual)
    B, C, H, W = x.shape
    out = torch.empty_like(x)
    lib = cuda_build.load("groupnorm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.etp_group_norm(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            params.weight.data_ptr(), params.bias.data_ptr(), out.data_ptr(),
            _DTYPES[x.dtype], B, C, H * W, groups, float(eps),
            int(relu), stream)
    cuda_build.check(err, "group_norm_fused")
    group_norm_launches.add()
    return out
