"""Multi-head attention with a head-shared additive bias, and the BERT
post-norm attention sub-blocks (counterpart of
`etpnav_tpu/ops/attention.py`).

Every attention goes through `ops/fused_attention.py::attention`: K-ATT
forward, and where autograd records, K-ATT-BWD backward through
`AttentionFn`; biased or not, with or without attention-prob dropout. The projections are read in their natural
(B, L, H, hd) layout and the context comes back in the layout the output
projection consumes, with no transposed copy. The JAX package's gates
(`Lk >= 128` for the biased kernel, TPU-only for the unbiased one, and
no kernel at all while dropout is on) were set from TPU measurements and
are not carried over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from etpnav_tpu_torch.ops.basic import LayerNorm, Linear, dropout
from etpnav_tpu_torch.ops.fused_attention import attention
from etpnav_tpu_torch.parallel.tensor_parallel import bias_to_mp, heads_of


class QKV(nn.Module):
    """q/k/v projections."""

    def __init__(self, dim: int, ctx_dim: Optional[int] = None):
        super().__init__()
        ctx_dim = ctx_dim or dim
        self.q = Linear(dim, dim)
        self.k = Linear(ctx_dim, dim)
        self.v = Linear(ctx_dim, dim)


class MHA(QKV):
    """q/k/v/o projections (the JAX package's `mha_init` tree)."""

    def __init__(self, dim: int, ctx_dim: Optional[int] = None):
        super().__init__(dim, ctx_dim)
        self.o = Linear(dim, dim)


def mha(params: nn.Module, q_in: torch.Tensor, kv_in: torch.Tensor,
        num_heads: int, bias: Optional[torch.Tensor] = None,
        o: Optional[Linear] = None, *, attn_dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
        train: bool = False) -> torch.Tensor:
    """q_in (B, Lq, D), kv_in (B, Lk, Dc), bias broadcastable to
    (B, 1, Lq, Lk) -> (B, Lq, D) after the output projection (`o`, or
    `params.o`). With `train` and a generator, the attention
    probabilities are dropped at `attn_dropout` inside the kernel. Under
    tensor parallelism (`parallel/tensor_parallel.py`) the projections
    hold this rank's heads, whose dropout draws are those heads' of the
    layer's one mask, and `o` sums the ranks' partial products."""
    B, Lq, D = q_in.shape
    hd = D // num_heads
    H, head_base, heads_total = heads_of(params.q, num_heads, hd)
    bias = bias_to_mp(bias, params.q)
    q = params.q(q_in).view(B, Lq, H, hd).transpose(1, 2)
    k = params.k(kv_in).view(B, -1, H, hd).transpose(1, 2)
    v = params.v(kv_in).view(B, -1, H, hd).transpose(1, 2)
    ctx = attention(q, k, v, bias, 1.0 / math.sqrt(hd),
                    attn_dropout if train else 0.0, generator,
                    head_base=head_base, heads_total=heads_total)
    ctx = ctx.transpose(1, 2).reshape(B, Lq, H * hd)
    return (o if o is not None else params.o)(ctx)


class AttentionOutput(nn.Module):
    """BertSelfOutput: the output projection and the residual LN."""

    def __init__(self, dim: int):
        super().__init__()
        self.dense = Linear(dim, dim)
        self.ln = LayerNorm(dim)


class AttentionBlock(nn.Module):
    """{'attn': {q,k,v}, 'out': {dense, ln}}: MHA whose o-projection is
    the BertSelfOutput dense (the JAX `self_attention_block_init`)."""

    def __init__(self, dim: int, ctx_dim: Optional[int] = None):
        super().__init__()
        self.attn = QKV(dim, ctx_dim)
        self.out = AttentionOutput(dim)


def self_attention_block(params: AttentionBlock, x: torch.Tensor,
                         num_heads: int, bias: Optional[torch.Tensor],
                         eps: float, *, hidden_dropout: float = 0.0,
                         attn_dropout: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         train: bool = False) -> torch.Tensor:
    """BERT post-norm self-attention sub-block:
    LN(x + Dropout(Dense(MHA(x))))."""
    return cross_attention_block(params, x, x, num_heads, bias, eps,
                                 hidden_dropout=hidden_dropout,
                                 attn_dropout=attn_dropout,
                                 generator=generator, train=train)


def cross_attention_block(params: AttentionBlock, x: torch.Tensor,
                          ctx: torch.Tensor, num_heads: int,
                          bias: Optional[torch.Tensor], eps: float, *,
                          hidden_dropout: float = 0.0,
                          attn_dropout: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          train: bool = False) -> torch.Tensor:
    """BertXAttention: cross-attention + residual LN."""
    h = mha(params.attn, x, ctx, num_heads, bias, o=params.out.dense,
            attn_dropout=attn_dropout, generator=generator, train=train)
    h = dropout(h, hidden_dropout, generator, train)
    return params.out.ln(x + h, eps)
