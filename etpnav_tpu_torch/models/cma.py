"""Legacy CMA policy: a cross-modal attention agent over low-level actions
(counterpart of `etpnav_tpu/models/cma.py`).

Capability target: the reference's legacy baseline path (the recurrent
CMA policy driven by dagger_trainer, and the Habitat-lineage instruction
encoder, encoders/instruction_encoder.py:9-101):

- instruction encoder: embedding + a GRU over the tokens;
- per step: attention over the instruction with the recurrent state as
  query, fused with the pooled RGB/depth features, a GRU state update
  and 4-way action logits (STOP / FORWARD / TURN-LEFT / TURN-RIGHT);
- `InstructionEncoderConfig` / `encode_instruction_rnn`: the reference's
  GRU/LSTM encoder over GloVe-style embeddings (R2R) or precomputed
  per-token features (RxR), bidirectional, with packed-sequence
  semantics.

No attention kernel is involved: the recurrences run as Python loops
over their cells, with the gate order of torch's `nn.GRU` / `nn.LSTM`.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from etpnav_tpu_torch.ops.basic import LayerNorm, Linear, init_weights

NUM_LOW_ACTIONS = 4


@dataclasses.dataclass(frozen=True)
class CMAConfig:
    vocab_size: int = 30522
    embed_dim: int = 256
    hidden_dim: int = 512
    rgb_dim: int = 512
    depth_dim: int = 128
    pad_token_id: int = 0


class GRUParams(nn.Module):
    """{wi: (in, 3h), wh: (h, 3h)} with the gates in (r, z, n) order."""

    def __init__(self, in_dim: int, hid: int):
        super().__init__()
        self.wi = Linear(in_dim, 3 * hid)
        self.wh = Linear(hid, 3 * hid)


class LSTMParams(nn.Module):
    """{wi: (in, 4h), wh: (h, 4h)} with the gates in torch's (i, f, g, o)
    order."""

    def __init__(self, in_dim: int, hid: int):
        super().__init__()
        self.wi = Linear(in_dim, 4 * hid)
        self.wh = Linear(hid, 4 * hid)


def gru_cell(params: GRUParams, x: torch.Tensor, h: torch.Tensor,
             gi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GRU update; `gi` is wi(x) when the caller has it already."""
    hid = h.shape[-1]
    gi = params.wi(x) if gi is None else gi
    gh = params.wh(h)
    r = torch.sigmoid(gi[..., :hid] + gh[..., :hid])
    z = torch.sigmoid(gi[..., hid:2 * hid] + gh[..., hid:2 * hid])
    n = torch.tanh(gi[..., 2 * hid:] + r * gh[..., 2 * hid:])
    return (1 - z) * n + z * h


def lstm_cell(params: LSTMParams, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, gi: Optional[torch.Tensor] = None):
    hid = h.shape[-1]
    g = (params.wi(x) if gi is None else gi) + params.wh(h)
    i = torch.sigmoid(g[..., :hid])
    f = torch.sigmoid(g[..., hid:2 * hid])
    gg = torch.tanh(g[..., 2 * hid:3 * hid])
    o = torch.sigmoid(g[..., 3 * hid:])
    c = f * c + i * gg
    return o * torch.tanh(c), c


class CMAParams(nn.Module):
    def __init__(self, cfg: CMAConfig):
        super().__init__()
        H = cfg.hidden_dim
        self.embedding = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                  cfg.embed_dim))
        self.instr_gru = GRUParams(cfg.embed_dim, H)
        self.visual_proj = Linear(cfg.rgb_dim + cfg.depth_dim, H)
        self.attn_q = Linear(H, H)
        self.state_gru = GRUParams(2 * H, H)
        self.state_ln = LayerNorm(H)
        self.action_head = Linear(H, NUM_LOW_ACTIONS)


def init_cma_params(cfg: CMAConfig, seed: int = 0) -> CMAParams:
    """Random parameters from a seeded `torch.Generator`, on the CPU."""
    params = CMAParams(cfg)
    init_weights(params, torch.Generator().manual_seed(seed))
    return params


def encode_instruction(params: CMAParams, cfg: CMAConfig,
                       tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) -> (B, L, H) GRU outputs + (B, L) mask."""
    mask = tokens != cfg.pad_token_id
    x = params.embedding[tokens.long()]
    gi = params.instr_gru.wi(x)                 # every step's input gates
    h = torch.zeros(tokens.shape[0], cfg.hidden_dim, dtype=x.dtype,
                    device=x.device)
    outs = []
    for t in range(tokens.shape[1]):
        h = gru_cell(params.instr_gru, None, h, gi[:, t])
        outs.append(h)
    return torch.stack(outs, dim=1) * mask[..., None], mask


def cma_step(params: CMAParams, cfg: CMAConfig, instr_feats: torch.Tensor,
             instr_mask: torch.Tensor, rgb_feat: torch.Tensor,
             dep_feat: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent decision: -> (logits (B, 4), new_state (B, H))."""
    vis = torch.relu(params.visual_proj(torch.cat([rgb_feat, dep_feat],
                                                  -1)))
    # attention over the instruction with the current state as query
    q = params.attn_q(state)                                   # (B, H)
    scores = torch.einsum("bh,blh->bl", q, instr_feats) \
        / float(np.sqrt(np.float32(q.shape[-1])))
    scores = torch.where(instr_mask, scores, -1e9)
    attn = torch.softmax(scores, dim=-1)
    instr_ctx = torch.einsum("bl,blh->bh", attn, instr_feats)
    new_state = gru_cell(params.state_gru, torch.cat([vis, instr_ctx], -1),
                         state)
    new_state = params.state_ln(new_state, 1e-6)
    return params.action_head(new_state), new_state


def initial_state(cfg: CMAConfig, batch: int, device=None) -> torch.Tensor:
    return torch.zeros(batch, cfg.hidden_dim, device=device)


# ---------------------------------------------------------------------------
# Habitat-lineage instruction encoder (encoders/instruction_encoder.py:9-101)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InstructionEncoderConfig:
    """The reference InstructionEncoder's config surface
    (instruction_encoder.py:14-20): GRU/LSTM over GloVe-style embeddings
    (R2R) or precomputed per-token features (RxR)."""

    vocab_size: int = 2504       # R2R vocab in the VLN-CE lineage
    embedding_size: int = 50     # GloVe-50
    hidden_size: int = 128
    rnn_type: str = "LSTM"       # 'GRU' | 'LSTM'
    bidirectional: bool = True
    final_state_only: bool = False
    sensor_uuid: str = "instruction"   # or 'rxr_instruction'

    @property
    def output_size(self) -> int:
        """instruction_encoder.py:49-51."""
        return self.hidden_size * (1 + int(self.bidirectional))


def load_pretrained_embeddings(path: str) -> torch.Tensor:
    """gzip-JSON embedding table (instruction_encoder.py:53-63): row 0 is
    PAD (zeros), row 1 UNK (mean of all rows)."""
    with gzip.open(path, "rt") as f:
        return torch.tensor(json.load(f), dtype=torch.float32)


class InstructionEncoderParams(nn.Module):
    """{fwd, bwd (bidirectional), embedding (the R2R token sensor only)}."""

    def __init__(self, cfg: InstructionEncoderConfig):
        super().__init__()
        rnn = LSTMParams if cfg.rnn_type == "LSTM" else GRUParams
        self.fwd = rnn(cfg.embedding_size, cfg.hidden_size)
        if cfg.bidirectional:
            self.bwd = rnn(cfg.embedding_size, cfg.hidden_size)
        if cfg.sensor_uuid == "instruction":
            self.embedding = nn.Parameter(
                torch.zeros(cfg.vocab_size, cfg.embedding_size))


def init_instruction_encoder(cfg: InstructionEncoderConfig, seed: int = 0,
                             embedding_weights: Optional[torch.Tensor] = None
                             ) -> InstructionEncoderParams:
    """Random parameters from a seeded `torch.Generator`; a given
    `embedding_weights` table (the frozen GloVe one,
    instruction_encoder.py:35-40) replaces the token embedding."""
    params = InstructionEncoderParams(cfg)
    init_weights(params, torch.Generator().manual_seed(seed))
    if embedding_weights is not None and cfg.sensor_uuid == "instruction":
        with torch.no_grad():
            params.embedding.copy_(embedding_weights)
    return params


def _run_rnn(params: nn.Module, cfg: InstructionEncoderConfig,
             x: torch.Tensor, lengths: torch.Tensor, reverse: bool):
    """A masked recurrence with pack_padded_sequence semantics: the state
    advances only on valid steps, outputs are zero past each sequence's
    length, and the final state is the state at the last valid step
    (instruction_encoder.py:84-91)."""
    B, L, _ = x.shape
    is_lstm = cfg.rnn_type == "LSTM"
    valid = torch.arange(L, device=x.device)[None] < lengths[:, None]
    gi = params.wi(x)
    h = torch.zeros(B, cfg.hidden_size, dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    outs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        v = valid[:, t, None]
        if is_lstm:
            nh, nc = lstm_cell(params, None, h, c, gi[:, t])
            c = torch.where(v, nc, c)
        else:
            nh = gru_cell(params, None, h, gi[:, t])
        h = torch.where(v, nh, h)
        outs[t] = torch.where(v, nh, 0.0)
    return torch.stack(outs, dim=1), h


def encode_instruction_rnn(params: InstructionEncoderParams,
                           cfg: InstructionEncoderConfig, observations: dict):
    """observations['instruction'] (B, L) int tokens, or
    observations['rxr_instruction'] (B, L, embedding_size) features.

    Returns the final state (B, output_size) when final_state_only, else
    (ctx (B, L, output_size), pad_mask (B, L) True at padding): the
    reference's (ctx, all_lang_masks) (instruction_encoder.py:93-101)."""
    if cfg.sensor_uuid == "instruction":
        tokens = observations["instruction"].long()
        lengths = (tokens != 0).sum(-1)
        x = params.embedding[tokens]
    else:
        x = observations["rxr_instruction"]
        lengths = ((x != 0.0).sum(-1) != 0).sum(-1)
    out_f, fin_f = _run_rnn(params.fwd, cfg, x, lengths, reverse=False)
    if cfg.bidirectional:
        out_b, fin_b = _run_rnn(params.bwd, cfg, x, lengths, reverse=True)
        ctx = torch.cat([out_f, out_b], -1)
        final = torch.cat([fin_f, fin_b], -1)
    else:
        ctx, final = out_f, fin_f
    if cfg.final_state_only:
        return final
    pad_mask = torch.arange(ctx.shape[1], device=ctx.device)[None] \
        >= lengths[:, None]
    return ctx, pad_mask
