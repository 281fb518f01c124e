"""FLOPs of ETPNav with DeepSeek-V2-Lite's decoder as its instruction
encoder: ETPNav's count (`navbench/work/model.py`) for perception,
scoring and the learn step, and `text` for the decoder, from the
configuration file's `model.text_llm` block (one multiply-add = 2 FLOPs;
products only).

`text(m, B, L)` counts B encodes at the padded length L, as the program
runs them: per layer the MLA projections (q, the compressed kv and k_pe,
kv_b, o), the two attention products at head width 192 (q and k, and v
zero-padded to q's width as K-ATT is called), and the MLP: the dense SiLU
MLP in the first `first_k_dense_replace` layers, else the router (fp32),
the shared experts, and the held experts' rows at the nominal share, k *
held / n_routed rows a token; then the projection to the planner's
width. Everything but the router is bf16 with `planner.use_bf16`.
"""

from __future__ import annotations

from collections import Counter

from navbench.work.model import (
    _hi,
    _w,
    attention,
    dense,
    nav,
    perceive,
    train_step,
)

__all__ = ["nav", "perceive", "text", "train_step"]


def text(m: dict, B: float, L: int) -> Counter:
    c = m["text_llm"]
    D, H = c["hidden_size"], c["num_heads"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    r, I = c["kv_lora_rank"], c["moe_intermediate_size"]
    n = B * L
    held = len(c["held_experts"]) or c["n_routed_experts"]
    attn = (dense(n, D, H * (dn + dr)) + dense(n, D, r + dr)
            + dense(n, r, H * (dn + dv)) + dense(n, H * dv, D)
            + attention(B, H, L, L, dn + dr))
    n_dense = c["first_k_dense_replace"]
    n_moe = c["num_layers"] - n_dense
    routed_rows = n * c["num_experts_per_tok"] * held / c["n_routed_experts"]
    moe = (3 * dense(n, D, I * c["n_shared_experts"])
           + 3 * dense(routed_rows, D, I))
    hi = (c["num_layers"] * attn + n_dense * 3 * dense(
        n, D, c["intermediate_size"]) + n_moe * moe
        + dense(n, D, m["planner"]["hidden_size"]))
    return _w(_hi(m), hi) + _w("fp32", n_moe * dense(n, D,
                                                     c["n_routed_experts"]))
