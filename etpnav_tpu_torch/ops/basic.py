"""Core tensor ops: norms, activations, masking, and the parameter
containers they read (counterpart of `etpnav_tpu/ops/basic.py`).

Numerics follow the JAX package: LayerNorm statistics in fp32 with eps
inside the rsqrt; dense layers accumulate in fp32 and return the input
dtype; additive masks use -10000, not -inf.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

# The reference builds additive masks as (1-m)*-10000 (common/ops.py:33).
NEG_INF = -10000.0


@functools.lru_cache(maxsize=None)
def _const(c: float, dtype: torch.dtype) -> float:
    """The Python constant `c` as JAX uses it against an array of
    `dtype`: a weakly typed scalar takes the array's dtype, so in bf16 it
    is rounded to bf16 before the op (1.702 -> 1.703125), where PyTorch
    would apply it in fp32."""
    return c if dtype == torch.float32 else float(
        torch.tensor(c, dtype=dtype))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (the reference BERT gelu), not the tanh form."""
    return x * 0.5 * (1.0 + torch.erf(x / _const(math.sqrt(2.0), x.dtype)))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(_const(1.702, x.dtype) * x)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with fp32 statistics, eps inside the rsqrt; returns the
    input dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a (..., K) @ b (K, N) (+ bias (N,) fp32) in fp32, for operands of
    one dtype: the JAX package's `jnp.dot(a, b,
    preferred_element_type=float32)` (+ bias). Every product of two bf16
    values is exact in fp32, so only the order of the fp32 sums differs
    between devices. On the card this is one cuBLAS call with fp32
    output and the bias in its epilogue (`torch.addmm(...,
    out_dtype=torch.float32)`, bf16 operands at the tensor cores' bf16
    rate). This CPU build of PyTorch has no bf16 x bf16 -> fp32 product,
    so on the CPU the operands are widened to fp32 first, which holds
    the same values. No autograd on the card: `linear` carries its own
    backward."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.dtype == torch.float32 or a.device.type != "cuda":
        y = torch.mm(a2.float(), b.float())
        if bias is not None:
            y = y + bias
    elif bias is None:
        y = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        y = torch.addmm(bias, a2, b, out_dtype=torch.float32)
    return y.view(*a.shape[:-1], b.shape[-1])


class _LinearRoundOnce(torch.autograd.Function):
    """y = round(x . w^T + bias) for bf16 x and w and an fp32 bias: the
    product in fp32, the bias added in fp32, one rounding to x's dtype,
    as the JAX package's `linear`. The backward follows JAX's transpose
    of that program: dx and dw are fp32 sums rounded once to bf16, and
    d(bias) the fp32 sum of the output gradient."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return matmul_f32(x, w.t(), bias).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = matmul_f32(g, w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = matmul_f32(g2.t(), x.reshape(-1, x.shape[-1])).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g2.float().sum(0)
        return dx, dw, db


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """Dense layer, weight (out, in), fp32 bias. fp32 x: one
    `F.linear`. bf16 x: the weight rounded to bf16, the product
    accumulated AND returned in fp32 (`matmul_f32`), the fp32 bias added,
    and one rounding to bf16, where JAX rounds. (A bf16 `F.linear` would
    round the bias to bf16 and the product before the bias is added.)
    On the CPU the bf16 product runs on fp32 operands that hold the
    bf16-rounded values: twice the bytes of a bf16 product, but this
    PyTorch has no bf16 x bf16 -> fp32 product there."""
    if x.dtype == torch.float32:
        return torch.nn.functional.linear(x, weight, bias)
    w = weight.to(x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or bias.requires_grad):
        return _LinearRoundOnce.apply(x, w, bias)
    # no graph to record (serving): the same forward without the
    # autograd.Function's host cost (~10-15 us a call on the H100 host)
    return matmul_f32(x, w.t(), bias).to(x.dtype)


def mask_to_bias(mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., L) bool -> additive bias: 0 where valid, NEG_INF where not."""
    return (1.0 - mask.to(dtype)) * NEG_INF


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool,
            shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout with the caller's generator (on x's device); the
    identity when not training, at rate 0 or without a generator. For an
    activation split on its last dim over a tensor-parallel group,
    `shard` = (first column, full width): the mask is drawn at the full
    width and this slice of it kept, so the ranks of the group drop
    what one process would (`parallel/tensor_parallel.py`)."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    if shard is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        start, full = shard
        n = x.shape[-1]
        u = torch.rand(*x.shape[:-1], full, generator=generator,
                       device=x.device)[..., start:start + n]
        if u.shape[-1] < n:          # the zero padding of the last shard
            u = torch.cat([u, u.new_ones(*x.shape[:-1],
                                         n - u.shape[-1])], -1)
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


def checkpointed(fn, generator: Optional[torch.Generator], *args,
                 **kwargs):
    """fn(*args, generator=..., **kwargs) under activation checkpointing
    (torch.utils.checkpoint, non-reentrant): backward recomputes fn's
    activations instead of keeping them. Runs fn plainly when no gradient
    is recorded.

    Dropout draws from the caller's own generator, which checkpoint's
    `preserve_rng_state` does not restore, so a plain recompute would
    draw new masks and the backward would differentiate a forward that
    never ran. Here both the forward and the recompute draw from a
    private generator started at the caller's state on entry, and the
    caller's generator is then moved to where the forward left it, as
    if fn had run without checkpointing."""
    if not torch.is_grad_enabled():
        return fn(*args, generator=generator, **kwargs)
    if generator is None:
        return torch.utils.checkpoint.checkpoint(
            functools.partial(fn, generator=None, **kwargs), *args,
            use_reentrant=False, preserve_rng_state=False)
    start = generator.get_state()
    end = []

    def run(*a):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = fn(*a, generator=g, **kwargs)
        if not end:                    # the forward, not the recompute
            end.append(g.get_state())
        return out

    out = torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(end[0])
    return out


class Linear(nn.Module):
    """Dense parameters in PyTorch's (out, in) layout."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if getattr(self.weight, "tp", None) is not None:
            # split over a tensor-parallel group (parallel/mesh.py)
            from etpnav_tpu_torch.parallel.tensor_parallel import \
                parallel_linear
            return parallel_linear(x, self.weight, self.bias)
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
