"""Plain reference of ETPNav with DeepSeek-V2-Lite's decoder as its
instruction encoder, in fp32 PyTorch: ETPNav's reference
(`navbench/reference/model.py`) with `encode_text` replaced.

It follows the published `modeling_deepseek.py` of
deepseek-ai/DeepSeek-V2-Lite, written out here from the configuration
file's `model.text_llm` block and the weights under the program's
parameter names (`text_llm.*`), and imports neither the program nor
JAX:

- embedding; per layer RMSNorm -> MLA -> residual, RMSNorm -> MLP or
  expert layer -> residual; a final RMSNorm; then ETPNav's projection
  (no bias) and LayerNorm to the planner's width;
- MLA without query compression: q = q_proj(x), [c, k_pe] =
  kv_a_proj_with_mqa(x), [k_nope, v] = kv_b_proj(RMSNorm(c)); YaRN rotary
  positions by the published `apply_rotary_pos_emb` (each head's rope
  dims de-interleaved, rotate-half) on q_pe and the one shared k_pe;
  softmax(q k^T * 192^-0.5 * mscale^2 + causal mask) v, mscale = 0.1 *
  mscale_all_dim * ln(factor) + 1;
- the expert layer: fp32 gate logits over all routed experts, softmax,
  greedy top-k with no renormalisation, times the scaling factor; then a
  loop over the held experts (`held_experts`, this card's share of the
  expert-parallel deployment), each on the tokens routed to it, weighted;
  routings to other experts add nothing; plus the shared experts.

`mode="fp8"` (the control) rounds the operands and outputs of every
dense product to float8 e4m3 under a per-tensor scale, as the base's
dense layers do; the router stays an fp32 product, of the rounded
input, as the program's reads its bf16 input in fp32. `mode="held_shift"`
is a fault reading for the limits (`navbench/control.py --others`), as
the half batch is for training: fp32, with the last held expert's
weights standing at the place of the first expert the share does not
hold, so one expert of the share is the wrong one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from navbench.reference.model import Drop
from navbench.reference.model import Ref as _Ref

__all__ = ["Drop", "Ref"]


class Ref(_Ref):

    def __init__(self, P, m: dict, mode: str = "fp32"):
        self.held_shift = mode == "held_shift"
        super().__init__(P, m, "fp32" if self.held_shift else mode)
        self.tl = m["text_llm"]

    # -- primitives ---------------------------------------------------------

    def dense(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x . w^T, no bias."""
        return self._q(self._q(x) @ self._q(w).t())

    def rms(self, name: str, x: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return self.P[name + ".weight"] * (
            x * torch.rsqrt(var + self.tl["rms_norm_eps"]))

    def mlp(self, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
        return self.dense(down, F.silu(self.dense(gate, x))
                          * self.dense(up, x))

    def rope(self, L: int, device) -> tuple:
        """The published DeepseekV2YarnRotaryEmbedding's cos and sin, (L,
        rope_dim)."""
        c = self.tl
        dim, base, factor = (c["qk_rope_head_dim"], c["rope_theta"],
                             c["rope_factor"])
        pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        freq_extra = 1.0 / (base ** (pos / dim))
        if factor <= 1:
            inv_freq, ms = freq_extra, 1.0
        else:
            freq_inter = 1.0 / (factor * base ** (pos / dim))

            def corr(rot):
                return (dim * math.log(c["rope_original_max_position"]
                                       / (rot * 2 * math.pi))
                        / (2 * math.log(base)))
            low = max(math.floor(corr(c["rope_beta_fast"])), 0)
            high = min(math.ceil(corr(c["rope_beta_slow"])), dim - 1)
            if low == high:
                high += 0.001
            ramp = torch.clamp(
                (torch.arange(dim // 2, dtype=torch.float32, device=device)
                 - low) / (high - low), 0, 1)
            inv_freq_mask = 1.0 - ramp
            inv_freq = (freq_inter * (1 - inv_freq_mask)
                        + freq_extra * inv_freq_mask)
            ms = (_mscale(factor, c["rope_mscale"])
                  / _mscale(factor, c["rope_mscale_all_dim"]))
        t = torch.arange(L, dtype=torch.float32, device=device)
        emb = torch.cat([torch.outer(t, inv_freq)] * 2, -1)
        return emb.cos() * ms, emb.sin() * ms

    @staticmethod
    def apply_rope(x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> torch.Tensor:
        """x (b, h, s, d), the published apply_rotary_pos_emb."""
        b, h, s, d = x.shape
        x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
        rot = torch.cat((-x[..., d // 2:], x[..., :d // 2]), -1)
        return x * cos + rot * sin

    # -- the decoder --------------------------------------------------------

    def mla(self, pre: str, x: torch.Tensor, cos, sin) -> torch.Tensor:
        c, P = self.tl, self.P
        B, L, _ = x.shape
        H, dn, dr, dv = (c["num_heads"], c["qk_nope_head_dim"],
                         c["qk_rope_head_dim"], c["v_head_dim"])
        r = c["kv_lora_rank"]
        q = self.dense(P[pre + ".q_proj.weight"], x)
        q = q.view(B, L, H, dn + dr).transpose(1, 2)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        ckv = self.dense(P[pre + ".kv_a_proj_with_mqa.weight"], x)
        compressed, k_pe = ckv[..., :r], ckv[..., r:]
        k_pe = k_pe.view(B, L, 1, dr).transpose(1, 2)
        kv = self.dense(P[pre + ".kv_b_proj.weight"],
                        self.rms(pre + ".kv_norm", compressed))
        kv = kv.view(B, L, H, dn + dv).transpose(1, 2)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q_pe = self.apply_rope(q_pe, cos, sin)
        k_pe = self.apply_rope(k_pe, cos, sin)
        qs = torch.cat([q_nope, q_pe], -1)
        ks = torch.cat([k_nope, k_pe.expand(B, H, L, dr)], -1)
        scale = (dn + dr) ** -0.5
        if c["rope_factor"] > 1 and c["rope_mscale_all_dim"]:
            scale *= _mscale(c["rope_factor"], c["rope_mscale_all_dim"]) ** 2
        logits = (qs @ ks.transpose(2, 3)) * scale
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, float("-inf"))
        ctx = torch.softmax(logits, -1) @ v
        ctx = ctx.transpose(1, 2).reshape(B, L, H * dv)
        return self.dense(P[pre + ".o_proj.weight"], ctx)

    def route(self, pre: str, h: torch.Tensor) -> tuple:
        """(T, k) weights and expert ids of (T, D) h."""
        c = self.tl
        logits = self._q(h) @ self.P[pre + ".gate.weight"].t()
        tw, ti = torch.topk(logits.softmax(-1), c["num_experts_per_tok"],
                            dim=-1, sorted=False)
        return tw * c["routed_scaling_factor"], ti

    def moe(self, pre: str, x: torch.Tensor,
            held: Optional[list] = None) -> torch.Tensor:
        """The held experts' part of the routed sum plus the shared
        experts. `held` (the experts whose weights are stacked under
        `pre`, in order) defaults to the configuration's share."""
        c, P = self.tl, self.P
        B, L, D = x.shape
        h = x.reshape(B * L, D)
        tw, ti = self.route(pre, h)
        if held is None:
            held = c["held_experts"] or list(range(c["n_routed_experts"]))
            if self.held_shift:
                held = held[:-1] + [min(set(range(c["n_routed_experts"]))
                                        - set(held))]
        out = torch.zeros_like(h)
        for j, e in enumerate(held):
            hit = ti == e
            rows = hit.any(-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            w = (tw * hit).sum(-1)[rows]
            gate, up = P[pre + ".experts_gate_up"][j].chunk(2)
            y = self.mlp(gate, up, P[pre + ".experts_down"][j], h[rows])
            out[rows] += w[:, None] * y
        out = out + self.mlp(P[pre + ".shared.gate_proj.weight"],
                             P[pre + ".shared.up_proj.weight"],
                             P[pre + ".shared.down_proj.weight"], h)
        return out.view(B, L, D)

    def decoder(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> the last hidden states after the final RMSNorm."""
        c, P = self.tl, self.P
        x = P["text_llm.embed_tokens"][ids]
        cos, sin = self.rope(ids.shape[1], ids.device)
        for i in range(c["num_layers"]):
            pre = f"text_llm.layers.{i}"
            x = x + self.mla(pre + ".attn",
                             self.rms(pre + ".input_norm", x), cos, sin)
            h = self.rms(pre + ".post_attn_norm", x)
            if i < c["first_k_dense_replace"]:
                x = x + self.mlp(P[pre + ".mlp.gate_proj.weight"],
                                 P[pre + ".mlp.up_proj.weight"],
                                 P[pre + ".mlp.down_proj.weight"], h)
            else:
                x = x + self.moe(pre + ".moe", h)
        return self.rms("text_llm.final_norm", x)

    def encode_text(self, ids: torch.Tensor, mask: torch.Tensor,
                    drop: Optional[Drop] = None) -> torch.Tensor:
        """(B, L) right-padded ids -> (B, L, planner width) text memory:
        the decoder, ETPNav's projection and its LayerNorm. `mask` is not
        read: the causal mask keeps every valid token from the pads."""
        t = self.dense(self.P["text_llm.proj.weight"], self.decoder(ids))
        return F.layer_norm(t, t.shape[-1:],
                            self.P["text_llm.proj_ln.weight"],
                            self.P["text_llm.proj_ln.bias"],
                            self.pl["lang_layer_norm_eps"])


def _mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0
