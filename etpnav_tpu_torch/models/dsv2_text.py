"""DeepSeek-V2's decoder as ETPNav's instruction encoder (a module of the
port only: the JAX package has no counterpart).

The decoder follows the published `modeling_deepseek.py` of
deepseek-ai/DeepSeek-V2-Lite: pre-RMSNorm residual blocks of multi-head
latent attention (MLA, without query compression) and an MLP, the first
`first_k_dense_replace` MLPs dense (SiLU(gate) * up), the rest mixtures
of routed experts plus shared experts; a final RMSNorm. ETPNav reads its
last hidden states through `proj` (2048 -> the planner's width, no
bias) and `proj_ln` (LayerNorm at `planner.lang_layer_norm_eps`): that
is the text memory the cross-modal layers attend to, after NavGPT-2
(arXiv:2407.12366).

- MLA: q = q_proj(x); [c, k_pe] = kv_a_proj_with_mqa(x); [k_nope, v] =
  kv_b_proj(RMSNorm(c)); YaRN rotary positions on q_pe and on the one
  k_pe that every head shares, in the published pair order (each head's
  rope dims de-interleaved, then rotate-half); q = [q_nope, q_pe], k =
  [k_nope, k_pe] at width 192, v zero-padded from 128 to 192 for K-ATT
  and its output cut back; a causal mask (instructions are right-padded,
  so a valid token sees no pad); softmax scale 192^-0.5 * mscale^2 with
  mscale = 0.1 * mscale_all_dim * ln(factor) + 1, as the published code
  has it (transformers 4.57's DeepseekV2Attention leaves mscale^2 out).
- MoE: fp32 gate logits over all routed experts, softmax, greedy top-k
  with no renormalisation, times `routed_scaling_factor`; the experts
  this process holds (`TextLLMConfig.held_experts`) compute their part
  for the tokens routed to them, by K-MOE (`ops/moe_gemm.py`: the tokens
  sorted by held expert, one launch for gate/up with the SiLU * up
  epilogue, one for down with the routing weight); routings to other
  experts add nothing here. Plus the shared experts, on every token.

Precision: the residual stream, RMSNorm statistics, rotary positions,
the router and the sum of the experts' parts are fp32; with
`planner.use_bf16` the products take bf16 operands, accumulate in fp32
and round their output once, as the port's `linear` does, and `Agent`
casts the decoder's matrices to bf16 once, in place
(`cast_matrices_`), so that the card holds them once. The decoder's
parameters are bias-free; its norm modules are named `*_norm` so that
seeded weights treat them as norm scales.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from etpnav_tpu_torch.config import ExperimentConfig, TextLLMConfig
from etpnav_tpu_torch.ops import attention as attn_ops
from etpnav_tpu_torch.ops import moe_gemm
from etpnav_tpu_torch.ops.basic import LayerNorm, layer_norm, matmul_f32, \
    trunc_normal_
from etpnav_tpu_torch.utils import logging as tracing

# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)


class Proj(nn.Module):
    """A dense layer without bias, (out, in)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))

    def init_(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, generator)


class MLA(nn.Module):
    def __init__(self, c: TextLLMConfig):
        super().__init__()
        D, H = c.hidden_size, c.num_heads
        self.q_proj = Proj(D, H * (c.qk_nope_head_dim + c.qk_rope_head_dim))
        self.kv_a_proj_with_mqa = Proj(D, c.kv_lora_rank + c.qk_rope_head_dim)
        self.kv_norm = RMSNorm(c.kv_lora_rank)
        self.kv_b_proj = Proj(c.kv_lora_rank,
                              H * (c.qk_nope_head_dim + c.v_head_dim))
        self.o_proj = Proj(H * c.v_head_dim, D)


class MLP(nn.Module):
    def __init__(self, dim: int, width: int):
        super().__init__()
        self.gate_proj = Proj(dim, width)
        self.up_proj = Proj(dim, width)
        self.down_proj = Proj(width, dim)


class MoE(nn.Module):
    """The router over all `n_routed_experts`, the held experts' weights
    stacked on a leading axis (gate and up as one (E, 2I, D): expert e's
    gate rows, then its up rows, as K-MOE reads them; down (E, D, I)),
    and the shared experts as one MLP of width n_shared * I."""

    def __init__(self, c: TextLLMConfig):
        super().__init__()
        D, I, E = c.hidden_size, c.moe_intermediate_size, len(c.held)
        self.gate = Proj(D, c.n_routed_experts)
        self.experts_gate_up = nn.Parameter(torch.zeros(E, 2 * I, D))
        self.experts_down = nn.Parameter(torch.zeros(E, D, I))
        self.shared = MLP(D, I * c.n_shared_experts)


class DecoderLayer(nn.Module):
    def __init__(self, c: TextLLMConfig, dense: bool):
        super().__init__()
        self.input_norm = RMSNorm(c.hidden_size)
        self.attn = MLA(c)
        self.post_attn_norm = RMSNorm(c.hidden_size)
        if dense:
            self.mlp = MLP(c.hidden_size, c.intermediate_size)
        else:
            self.moe = MoE(c)


class TextLLMParams(nn.Module):
    def __init__(self, c: TextLLMConfig, out_dim: int):
        super().__init__()
        self.embed_tokens = nn.Parameter(torch.zeros(c.vocab_size,
                                                     c.hidden_size))
        self.layers = nn.ModuleList(
            DecoderLayer(c, i < c.first_k_dense_replace)
            for i in range(c.num_layers))
        self.final_norm = RMSNorm(c.hidden_size)
        self.proj = Proj(c.hidden_size, out_dim)
        self.proj_ln = LayerNorm(out_dim)


def check_config(c: TextLLMConfig) -> None:
    held = c.held
    if len(set(held)) != len(held) or not all(
            0 <= e < c.n_routed_experts for e in held):
        raise ValueError(f"held_experts {held} are not distinct experts of "
                         f"{c.n_routed_experts}")
    if not 1 <= c.num_experts_per_tok <= c.n_routed_experts:
        raise ValueError("num_experts_per_tok outside 1..n_routed_experts")


def refuse_training(cfg: ExperimentConfig, trainer: str) -> None:
    """Raises for a configuration that enables the encoder: it is frozen
    and serves only."""
    if cfg.text_llm.enabled:
        raise ValueError(
            f"{trainer}: TEXT_LLM.enabled selects the frozen DeepSeek-V2 "
            "text encoder, which serves only: a frozen 4.7 B-parameter "
            "encoder has no place in AdamW's state; train with the BERT "
            "text stack (TEXT_LLM.enabled false)")


def cast_matrices_(p: TextLLMParams, dtype: torch.dtype) -> None:
    """Casts the decoder's matrices, in place, to the dtype its products
    take: every bias-free dense weight but the router's, and the held
    experts' stacks. The router, the norms, the embedding and `proj_ln`
    stay fp32. A frozen encoder so rounds each weight once, and a later
    in-place copy into a parameter (a load) rounds as it copies."""
    with torch.no_grad():
        for name, q in p.named_parameters():
            if (q.dim() >= 2 and name != "embed_tokens"
                    and not name.endswith("moe.gate.weight")):
                q.data = q.data.to(dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(c: TextLLMConfig) -> float:
    """192^-0.5, times mscale(factor, mscale_all_dim)^2 under YaRN."""
    s = (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5
    if c.rope_factor > 1 and c.rope_mscale_all_dim:
        m = yarn_mscale(c.rope_factor, c.rope_mscale_all_dim)
        s = s * m * m
    return s


def rope_inv_freq(c: TextLLMConfig) -> torch.Tensor:
    """The published YaRN frequencies (DeepseekV2YarnRotaryEmbedding), or
    plain RoPE's where `rope_factor` <= 1; fp32, (rope_dim / 2,)."""
    dim, base = c.qk_rope_head_dim, c.rope_theta
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim))
    if c.rope_factor <= 1:
        return extra
    inter = extra / c.rope_factor

    def corr_dim(rot):
        return (dim * math.log(c.rope_original_max_position
                               / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr_dim(c.rope_beta_fast)), 0)
    high = min(math.ceil(corr_dim(c.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_table(c: TextLLMConfig, L: int) -> tuple:
    """(cos, sin), fp32 (L, rope_dim), times the YaRN mscale ratio."""
    freqs = torch.outer(torch.arange(L, dtype=torch.float32),
                        rope_inv_freq(c))
    emb = torch.cat([freqs, freqs], -1)
    m = 1.0
    if c.rope_factor > 1:
        m = (yarn_mscale(c.rope_factor, c.rope_mscale)
             / yarn_mscale(c.rope_factor, c.rope_mscale_all_dim))
    return emb.cos() * m, emb.sin() * m


@functools.lru_cache(maxsize=None)
def _constants(c: TextLLMConfig, L: int, device: str) -> dict:
    """What every encode of length L reads on `device`, made there once:
    a copy from the host at each call would wait for the device."""
    cos, sin = rope_table(c, L)
    lut = torch.full((c.n_routed_experts,), len(c.held), dtype=torch.long)
    lut[list(c.held)] = torch.arange(len(c.held))
    bias = torch.full((L, L), float("-inf")).triu(1)[None]
    return {k: v.to(device) for k, v in (("cos", cos), ("sin", sin),
                                          ("lut", lut), ("bias", bias))}


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, L, heads, d), fp32: each head's d dims de-interleaved (pairs
    (0, 1), (2, 3), ... become [0, 2, ..., 1, 3, ...]) and rotated by
    rotate-half, as the published `apply_rotary_pos_emb`."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos[:, None] + rot * sin[:, None]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """The published RMSNorm on fp32 x: weight * x * rsqrt(mean(x^2) +
    eps), fp32."""
    x = x.float()
    return weight * (x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                     + eps))


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x . w^T, w (out, in) taken in x's dtype (already so after
    `cast_matrices_`): fp32 as it is; bf16 operands accumulated in fp32
    and rounded once."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return torch.nn.functional.linear(x, w)
    return matmul_f32(x, w.t()).to(x.dtype)


def _mlp(x: torch.Tensor, m: MLP) -> torch.Tensor:
    g, u = _mm(x, m.gate_proj.weight), _mm(x, m.up_proj.weight)
    return _mm((torch.nn.functional.silu(g.float()) * u.float()).to(x.dtype),
               m.down_proj.weight)


def mla(a: MLA, c: TextLLMConfig, h: torch.Tensor, bias: torch.Tensor,
        rope: tuple) -> torch.Tensor:
    """MLA on the normed hidden states h (B, L, D) in the compute dtype;
    returns o_proj's output in that dtype."""
    B, L, _ = h.shape
    H, dn, dr, dv = (c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim,
                     c.v_head_dim)
    r = c.kv_lora_rank
    q = _mm(h, a.q_proj.weight).view(B, L, H, dn + dr)
    ckv = _mm(h, a.kv_a_proj_with_mqa.weight)
    c_kv = rms_norm(ckv[..., :r], a.kv_norm.weight, c.rms_norm_eps)
    kv = _mm(c_kv.to(h.dtype), a.kv_b_proj.weight).view(B, L, H, dn + dv)
    cos, sin = rope
    q_pe = apply_rope(q[..., dn:].float(), cos, sin).to(h.dtype)
    k_pe = apply_rope(ckv[..., None, r:].float(), cos, sin).to(h.dtype)
    qh = torch.cat([q[..., :dn], q_pe], -1)
    kh = torch.cat([kv[..., :dn], k_pe.expand(B, L, H, dr)], -1)
    vh = torch.nn.functional.pad(kv[..., dn:], (0, dn + dr - dv))
    ctx = attn_ops.attention(qh.transpose(1, 2), kh.transpose(1, 2),
                             vh.transpose(1, 2), bias, softmax_scale(c))
    ctx = ctx.transpose(1, 2)[..., :dv].reshape(B, L, H * dv)
    return _mm(ctx, a.o_proj.weight)


def route(gate_weight: torch.Tensor, h: torch.Tensor,
          c: TextLLMConfig) -> tuple:
    """The published MoEGate: fp32 logits of (T, D) h over all routed
    experts, softmax, greedy top-k (unsorted), no renormalisation, times
    the scaling factor. -> (weights (T, k) fp32, expert ids (T, k))."""
    scores = (h.float() @ gate_weight.float().t()).softmax(-1)
    tw, ti = torch.topk(scores, c.num_experts_per_tok, dim=-1, sorted=False)
    return tw * c.routed_scaling_factor, ti


def moe(m: MoE, c: TextLLMConfig, h: torch.Tensor, lut: torch.Tensor,
        counts: Optional[torch.Tensor]) -> torch.Tensor:
    """The expert layer on the normed (B, L, D) h: the held experts' part
    of the routed sum plus the shared experts, fp32. Every shape is
    fixed by (B, L): the T*k routings are sorted by held expert (routings
    to other experts last; `lut` maps an expert id to its place among
    the held ones, or E), so no count leaves the device. `counts`
    (int64, 4) takes [rows the held experts computed, held experts with
    a row, routings elsewhere, 0]."""
    B, L, D = h.shape
    T, k, E = B * L, c.num_experts_per_tok, len(c.held)
    hf = h.reshape(T, D)
    tw, ti = route(m.gate.weight, hf, c)
    local = lut[ti].reshape(-1)
    order = torch.argsort(local, stable=True)
    # counted in place: bincount would read the largest id to the host
    cnt = torch.zeros(E + 1, dtype=torch.long, device=h.device).index_add_(
        0, local, torch.ones_like(local))
    offsets = torch.cat([cnt.new_zeros(1), cnt[:E].cumsum(0)]).to(
        torch.int32)
    inter = moe_gemm.moe_gate_up(hf[order // k],
                                 m.experts_gate_up.to(h.dtype), offsets)
    y = moe_gemm.moe_down(inter, m.experts_down.to(h.dtype), offsets,
                          tw.reshape(-1)[order].contiguous(),
                          order.to(torch.int32), T * k)
    if counts is not None:
        counts += torch.stack([cnt[:E].sum(), (cnt[:E] > 0).sum(), cnt[E],
                               cnt.new_zeros(())])
    out = y.view(T, k, D).sum(1) + _mlp(hf, m.shared).float()
    return out.view(B, L, D)


def encode(p: TextLLMParams, cfg: ExperimentConfig, ids: torch.Tensor,
           mask: torch.Tensor, counts: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """(B, L) ids, right-padded, and their (B, L) bool mask -> (B, L,
    planner width) fp32 text memory: `decode`, then `proj` and
    `proj_ln`. `counts` (int64, 4) takes the expert counters of `moe`
    and, in its last entry, the valid tokens."""
    dtype = torch.bfloat16 if cfg.planner.use_bf16 else torch.float32
    if counts is not None:
        counts[3] += mask.sum()
    h = decode(p, cfg, ids, counts).to(dtype)
    t = _mm(h, p.proj.weight).float()
    return layer_norm(t, p.proj_ln.weight, p.proj_ln.bias,
                      cfg.planner.lang_layer_norm_eps)


def decode(p: TextLLMParams, cfg: ExperimentConfig, ids: torch.Tensor,
           counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L) ids -> the decoder's last hidden states after the final
    RMSNorm, fp32 (B, L, hidden)."""
    c = cfg.text_llm
    dtype = torch.bfloat16 if cfg.planner.use_bf16 else torch.float32
    B, L = ids.shape
    dev = ids.device
    x = p.embed_tokens[ids].float()
    k = _constants(c, L, str(dev))
    bias, rope = k["bias"], (k["cos"], k["sin"])
    for layer in p.layers:
        with tracing.span("agent.mla", device=dev):
            h = rms_norm(x, layer.input_norm.weight, c.rms_norm_eps)
            x = x + mla(layer.attn, c, h.to(dtype), bias, rope).float()
        h = rms_norm(x, layer.post_attn_norm.weight, c.rms_norm_eps).to(dtype)
        if hasattr(layer, "mlp"):
            x = x + _mlp(h, layer.mlp).float()
        else:
            with tracing.span("agent.moe", device=dev):
                x = x + moe(layer.moe, c, h, k["lut"], counts)
    return rms_norm(x, p.final_norm.weight, c.rms_norm_eps)

