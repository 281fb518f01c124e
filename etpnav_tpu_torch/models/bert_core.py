"""BERT building blocks: embeddings, post-norm encoder layers and the
pre-norm layers of the pano encoder (counterpart of
`etpnav_tpu/models/bert_core.py`).

The JAX package stores a stack's layers on a leading axis and runs them
under `lax.scan`; here each layer is its own module in an
`nn.ModuleList`, run by a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from etpnav_tpu_torch.ops.attention import (
    MHA,
    AttentionBlock,
    mha,
    self_attention_block,
)
from etpnav_tpu_torch.ops.basic import LayerNorm, Linear, dropout, gelu_erf
from etpnav_tpu_torch.parallel import tensor_parallel


class BertDims(NamedTuple):
    hidden: int
    heads: int
    intermediate: int
    eps: float
    hidden_dropout: float = 0.0
    attn_dropout: float = 0.0


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

class BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, hidden: int, max_pos: int,
                 type_vocab: int):
        super().__init__()
        self.word_embeddings = nn.Parameter(torch.zeros(vocab, hidden))
        self.position_embeddings = nn.Parameter(torch.zeros(max_pos, hidden))
        self.token_type_embeddings = nn.Parameter(
            torch.zeros(type_vocab, hidden))
        self.ln = LayerNorm(hidden)


def bert_embeddings(params: BertEmbeddings, input_ids: torch.Tensor,
                    eps: float,
                    token_type_ids: Optional[torch.Tensor] = None, *,
                    hidden_dropout: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False) -> torch.Tensor:
    """word + position + type embeddings, LN, dropout. Positions are plain
    arange(L), as in the reference (also for the XLM-R variant)."""
    L = input_ids.shape[1]
    x = tensor_parallel.embedding(params.word_embeddings, input_ids)
    x = x + params.position_embeddings[:L][None]
    if token_type_ids is None:
        x = x + params.token_type_embeddings[0]
    else:
        x = x + params.token_type_embeddings[token_type_ids]
    return dropout(params.ln(x, eps), hidden_dropout, generator, train)


# ---------------------------------------------------------------------------
# Post-norm BERT layer (attention + FFN)
# ---------------------------------------------------------------------------

class FFNOutput(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.dense = Linear(intermediate, hidden)
        self.ln = LayerNorm(hidden)


class BertFFN(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.intermediate = Linear(hidden, intermediate)
        self.output = FFNOutput(hidden, intermediate)


def bert_ffn(params: BertFFN, x: torch.Tensor, eps: float, *,
             hidden_dropout: float = 0.0,
             generator: Optional[torch.Generator] = None,
             train: bool = False) -> torch.Tensor:
    """BertIntermediate + BertOutput: LN(x + Drop(W2 gelu(W1 x)))."""
    h = gelu_erf(params.intermediate(x))
    h = dropout(params.output.dense(h), hidden_dropout, generator, train)
    return params.output.ln(x + h, eps)


class BertLayer(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.attention = AttentionBlock(hidden)
        self.ffn = BertFFN(hidden, intermediate)


def bert_layer(params: BertLayer, x: torch.Tensor,
               bias: Optional[torch.Tensor], dims: BertDims, *,
               generator: Optional[torch.Generator] = None,
               train: bool = False) -> torch.Tensor:
    x = self_attention_block(
        params.attention, x, dims.heads, bias, dims.eps,
        hidden_dropout=dims.hidden_dropout, attn_dropout=dims.attn_dropout,
        generator=generator, train=train)
    return bert_ffn(params.ffn, x, dims.eps,
                    hidden_dropout=dims.hidden_dropout, generator=generator,
                    train=train)


def bert_stack_modules(num_layers: int, hidden: int,
                       intermediate: int) -> nn.ModuleList:
    return nn.ModuleList(BertLayer(hidden, intermediate)
                         for _ in range(num_layers))


def bert_stack(layers: nn.ModuleList, x: torch.Tensor,
               bias: Optional[torch.Tensor], dims: BertDims, *,
               generator: Optional[torch.Generator] = None,
               train: bool = False) -> torch.Tensor:
    """Run a stack of post-norm BERT layers."""
    for layer in layers:
        x = bert_layer(layer, x, bias, dims, generator=generator,
                       train=train)
    return x


# ---------------------------------------------------------------------------
# Pre-norm transformer layer (pano encoder, common/transformer.py:170-182)
# ---------------------------------------------------------------------------

class PrenormLayer(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.attn = MHA(hidden)
        self.norm1 = LayerNorm(hidden)
        self.norm2 = LayerNorm(hidden)
        self.linear1 = Linear(hidden, intermediate)
        self.linear2 = Linear(intermediate, hidden)


def prenorm_layer(params: PrenormLayer, x: torch.Tensor,
                  bias: Optional[torch.Tensor], dims: BertDims, *,
                  generator: Optional[torch.Generator] = None,
                  train: bool = False) -> torch.Tensor:
    """x + MHA(LN1(x)); x + W2 drop(gelu(W1 LN2(x))). dims.eps is the
    inner LayerNorms' eps (1e-5 in the pano encoder)."""
    p = dims.hidden_dropout
    h = params.norm1(x, dims.eps)
    h = mha(params.attn, h, h, dims.heads, bias,
            attn_dropout=dims.attn_dropout, generator=generator, train=train)
    x = x + dropout(h, p, generator, train)
    h = params.norm2(x, dims.eps)
    h = dropout(gelu_erf(params.linear1(h)), p, generator, train,
                shard=tensor_parallel.dropout_shard(params.linear1))
    return x + dropout(params.linear2(h), p, generator, train)


class PrenormStack(nn.Module):
    def __init__(self, num_layers: int, hidden: int, intermediate: int):
        super().__init__()
        self.layers = nn.ModuleList(PrenormLayer(hidden, intermediate)
                                    for _ in range(num_layers))
        self.final_ln = LayerNorm(hidden)


def prenorm_stack(params: PrenormStack, x: torch.Tensor,
                  bias: Optional[torch.Tensor], dims: BertDims,
                  final_eps: float, *,
                  generator: Optional[torch.Generator] = None,
                  train: bool = False) -> torch.Tensor:
    for layer in params.layers:
        x = prenorm_layer(layer, x, bias, dims, generator=generator,
                          train=train)
    return params.final_ln(x, final_eps)
