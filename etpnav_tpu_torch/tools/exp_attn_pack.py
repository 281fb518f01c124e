"""Cheaper softmax handling at the CLIP shape, on the card: the port's
counterpart of the JAX package's `tools/exp_attn_pack.py`.

Head-leading (B, H, L, hd) bf16 inputs. Variants:
  v_base  - K-ATT (fp32 logits, max shift);
  v_p1bf  - K-ATT-CHEAP: bf16 logits and a constant shift of 10, no max
            pass (the port of the TPU kernel `cheap_attention`).
The JAX tool's v_pack2 and v_p2bf pack two samples into one 128x128
matrix tile, which fills the TPU's matrix unit only; they compute the
functions of v_base and v_p1bf (the cross blocks weigh e^-40 each), so
they are not run again and the report names them under
`no_card_counterpart`.
Each is held to the JAX tool's fp32-logits reference (`xla_ref`): K-ATT
within two bf16 ulps of the reference's largest output (see
`exp_attn_layout`); K-ATT-CHEAP within CHEAP_ULPS of them, since rounding
a logit to bf16 moves it by up to 2^-9 of itself (scaled logits reach
~5 at these inputs, so p moves by up to ~1%), and the product with the
scale, the shift by 10 and exp round three times more.

Usage: python -m etpnav_tpu_torch.tools.exp_attn_pack
"""

from __future__ import annotations

import json
import math

from etpnav_tpu_torch.device import resolve_device
from etpnav_tpu_torch.ops.fused_attention import (
    attention_cheap,
    attention_fwd,
)
from etpnav_tpu_torch.tools import (
    bf16_normals,
    bf16_ulps,
    reference,
    run_variants,
)

CHEAP_ULPS = 4
#: the JAX tool's packed variants and the variant whose function each is
PACKED = {"v_pack2": "v_base", "v_p2bf": "v_p1bf"}


def main(device="cuda", *, B: int = 384, H: int = 12, L: int = 50,
         hd: int = 64, iters: int = 100, seed: int = 0) -> dict:
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(hd)
    q, k, v = bf16_normals(seed, (B, H, L, hd), dev)

    def base(q, k, v):
        return attention_fwd(q, k, v, None, scale)

    def cheap(q, k, v):
        return attention_cheap(q, k, v, scale)

    ref = reference(q, k, v, scale)
    tol, tol_cheap = bf16_ulps(ref, 2), bf16_ulps(ref, CHEAP_ULPS)
    variants = {
        "v_base": (base, tol, "K-ATT"),
        "v_p1bf": (cheap, tol_cheap, "K-ATT-CHEAP"),
    }
    res = run_variants("exp_attn_pack", variants, q, k, v, ref, iters)
    res["no_card_counterpart"] = {
        name: f"pack=2 fills the TPU's 128x128 matrix unit only; computes "
              f"{same}'s function" for name, same in PACKED.items()}
    return res


if __name__ == "__main__":
    print(json.dumps(main()))
