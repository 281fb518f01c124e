"""Attention input/output layouts at the CLIP shape, on the card: the
port's counterpart of the JAX package's `tools/exp_attn_layout.py`.

The projections give q/k/v in the natural (B, L, H, hd) layout. Variants,
each returning (B, L, H, hd) bf16:
  xla_t  - head-leading copies of q/k/v, K-ATT writing a head-leading
           output, a copy back;
  blhd   - K-ATT reading the natural strides in place and writing the
           natural layout: no copy (what the port's `mha` does);
  bdims  - K-ATT reading the natural strides and writing a head-leading
           output (`out_layout="head"`, the port of the TPU kernel
           `bdims_attention`), then one transpose copy.
Each is held to the JAX tool's fp32-logits reference (`xla_ref`) within
two bf16 ulps of the reference's largest output: K-ATT rounds the
unnormalised p before p.v and divides last, the reference rounds the
normalised p, and both round the output.

Usage: python -m etpnav_tpu_torch.tools.exp_attn_layout
"""

from __future__ import annotations

import json
import math

from etpnav_tpu_torch.device import resolve_device
from etpnav_tpu_torch.ops.fused_attention import attention_fwd
from etpnav_tpu_torch.tools import (
    bf16_normals,
    bf16_ulps,
    reference,
    run_variants,
)


def main(device="cuda", *, B: int = 384, H: int = 12, L: int = 50,
         hd: int = 64, iters: int = 100, seed: int = 0) -> dict:
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(hd)
    q, k, v = bf16_normals(seed, (B, L, H, hd), dev)

    def heads(t):                        # (B, L, H, hd) -> (B, H, L, hd) view
        return t.transpose(1, 2)

    def xla_t(q, k, v):
        h = [heads(t).contiguous() for t in (q, k, v)]
        return heads(attention_fwd(*h, None, scale,
                                   out_layout="head")).contiguous()

    def blhd(q, k, v):
        return heads(attention_fwd(heads(q), heads(k), heads(v), None,
                                   scale))

    def bdims(q, k, v):
        return heads(attention_fwd(heads(q), heads(k), heads(v), None, scale,
                                   out_layout="head")).contiguous()

    ref = heads(reference(heads(q), heads(k), heads(v), scale))
    tol = bf16_ulps(ref, 2)
    variants = {
        "xla_t": (xla_t, tol, "3 head-leading copies, K-ATT (head-leading "
                              "out), 1 copy back"),
        "blhd": (blhd, tol, "K-ATT on the natural strides, natural out, no "
                            "copy"),
        "bdims": (bdims, tol, "K-ATT on the natural strides, head-leading "
                              "out (T1), 1 copy"),
    }
    return run_variants("exp_attn_layout", variants, q, k, v, ref, iters)


if __name__ == "__main__":
    print(json.dumps(main()))
