"""Core tensor ops: norms, activations, masking, and the parameter
containers they read (counterpart of `etpnav_tpu/ops/basic.py`).

Numerics follow the JAX package: LayerNorm statistics in fp32 with eps
inside the rsqrt; dense layers accumulate in fp32 and return the input
dtype; additive masks use -10000, not -inf.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

# The reference builds additive masks as (1-m)*-10000 (common/ops.py:33).
NEG_INF = -10000.0


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (the reference BERT gelu), not the tanh form."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with fp32 statistics, eps inside the rsqrt; returns the
    input dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """Dense layer, weight (out, in). The product accumulates in fp32
    (cuBLAS does for bf16 operands) and the result has the input dtype."""
    return torch.nn.functional.linear(x, weight.to(x.dtype),
                                      bias.to(x.dtype))


def mask_to_bias(mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., L) bool -> additive bias: 0 where valid, NEG_INF where not."""
    return (1.0 - mask.to(dtype)) * NEG_INF


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool
            ) -> torch.Tensor:
    """Inverted dropout with the caller's generator (on x's device); the
    identity when not training, at rate 0 or without a generator."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


class Linear(nn.Module):
    """Dense parameters in PyTorch's (out, in) layout."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)

    def init_(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()


class LayerNorm(nn.Module):
    """LayerNorm parameters; eps is given per call, as the stacks of the
    model use different ones."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps)

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02) -> torch.Tensor:
    """BERT-style truncated normal init (initializer_range=0.02)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                     generator=generator).mul_(std)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random init of a parameter tree, as the JAX package's `*_init`
    functions do it: modules with an `init_` method (Linear, LayerNorm,
    convolutions) init themselves; every other parameter (embedding
    tables, CLIP's patch/class/positional embeddings and projection) is
    truncated normal with std 0.02."""
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(generator)
            continue
        for p in m.parameters(recurse=False):
            trunc_normal_(p, generator)
