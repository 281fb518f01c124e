"""FLOPs of ETPNav's device programs, from the shapes that ran and the
configuration file's `model` block (one multiply-add = 2 FLOPs; only
products are counted: dense layers, convolutions, the two attention
products). Each function returns {"bf16": FLOPs, "fp32": FLOPs}, split by
the precision the part runs in on the program's default path:

- bf16 (with `planner.use_bf16`): CLIP, the depth ResNet, the text,
  pano and navigation transformer stacks;
- fp32: the waypoint transformer (it reads the depth features in fp32),
  the pano token projections (they read fp32 features) and the SAP head
  (it reads the fp32 graph embeddings).

`train_step` counts a learn step at its (T, G) bucket: the forward, and
twice the forward's products for the backward (the input and the weight
gradients); the text stack's backward only where it is trained.

This is the FLOP-count module of a configuration file that names none
under `work` (`navbench/common.py`, `MODULES`). A count module provides
`perceive(m, B)`, `nav(m, B, G, L)`, `text(m, B, L)` and
`train_step(m, B, T, G, L)`, which the drivers call, each returning a
Counter {"bf16": FLOPs, "fp32": FLOPs}: that dict is the contract. The
drivers sum it over the window, and `seconds_at_peak` below, which knows
no architecture, turns the sum into `mfu.serve` and `mfu.train`. A new
architecture's module takes what it shares with ETPNav from here and
defines what differs.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

Work = Dict[str, float]


def _w(prec: str, flops: float) -> Counter:
    return Counter({prec: float(flops)})


def dense(rows: float, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def attention(B: float, H: int, Lq: int, Lk: int, hd: int) -> float:
    """q k^T and p v."""
    return 4.0 * B * H * Lq * Lk * hd


def _hi(m: dict) -> str:
    return "bf16" if m["planner"]["use_bf16"] else "fp32"


def bert_layer(B: float, Lq: int, D: int, inter: int, H: int,
               Lk: int = None) -> float:
    """Post-norm BERT layer, or a cross-attention block plus FFN when
    Lk is given (q on Lq rows, k and v on Lk rows)."""
    Lk = Lq if Lk is None else Lk
    return (dense(B * Lq, D, D) * 2 + dense(B * Lk, D, D) * 2
            + attention(B, H, Lq, Lk, D // H)
            + dense(B * Lq, D, inter) + dense(B * Lq, inter, D))


def text(m: dict, B: float, L: int) -> Counter:
    p = m["planner"]
    D = p["hidden_size"]
    return _w(_hi(m), p["num_l_layers"] * bert_layer(
        B, L, D, p["intermediate_size"], p["num_heads"]))


def clip(m: dict, n: float) -> Counter:
    """n images; the last block computes the class row only (its keys and
    values over all tokens), as the image embedding reads nothing else."""
    c = m["clip"]
    W, ps = c["width"], c["patch_size"]
    T = (c["image_size"] // ps) ** 2 + 1
    f = dense(n * (T - 1), ps * ps * 3, W)
    blk = (dense(n * T, W, W) * 4 + attention(n, c["heads"], T, T,
                                              W // c["heads"])
           + dense(n * T, W, 4 * W) * 2)
    f += (c["layers"] - 1) * blk
    f += (dense(n, W, W) * 2 + dense(n * T, W, W) * 2
          + attention(n, c["heads"], 1, T, W // c["heads"])
          + dense(n, W, 4 * W) * 2)
    f += dense(n, W, c["output_dim"])
    return _w(_hi(m), f)


def conv(n: float, hw_out: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * n * hw_out * hw_out * c_out * c_in * k * k


def depth(m: dict, n: float) -> Counter:
    """n depth images through the ResNet trunk and the compression conv,
    at the exact conv shapes."""
    d = m["depth"]
    bp, exp = d["baseplanes"], d["expansion"]
    s = d["input_size"] // 2                      # stem conv, stride 2
    f = conv(n, s, 1, bp, 7)
    s //= 2                                       # max pool
    c_in = bp
    for li, blocks in enumerate(d["layers"]):
        planes = bp * 2 ** li
        for bi in range(blocks):
            stride = (1 if li == 0 else 2) if bi == 0 else 1
            s_out = s // stride
            f += conv(n, s, c_in, planes, 1)
            f += conv(n, s_out, planes, planes, 3)
            f += conv(n, s_out, planes, planes * exp, 1)
            if bi == 0 and (c_in != planes * exp or li > 0):
                f += conv(n, s_out, c_in, planes * exp, 1)
            c_in, s = planes * exp, s_out
    comp = int(round(d["output_size"] / (s * s)))
    f += conv(n, s, c_in, comp, 3)
    return _w(_hi(m), f)


def waypoint(m: dict, B: float) -> Counter:
    w = m["waypoint"]
    D, V = w["hidden_size"], w["num_images"]
    flat = 1
    for x in w["depth_feat_shape"]:
        flat *= x
    per_img = w["num_distances"] * w["num_angles"] // V
    f = dense(B * V, flat, D)
    f += w["num_layers"] * bert_layer(B, V, D, 4 * D, w["num_heads"])
    f += dense(B * V, D, D) + dense(B * V, D, per_img)
    return _w("fp32", f)


def pano(m: dict, rows: float, P: int) -> Counter:
    """rows pano token sets of P tokens: the token projections (fp32)
    and the pre-norm pano encoder."""
    p = m["planner"]
    D, I, H = p["hidden_size"], p["intermediate_size"], p["num_heads"]
    out = _w("fp32", dense(rows * P, p["image_feat_size"], D)
             + dense(rows * P, p["depth_feat_size"], D)
             + dense(rows * P, p["angle_feat_size"], D))
    out += _w(_hi(m), p["num_pano_layers"] * bert_layer(rows, P, D, I, H))
    return out


def nav(m: dict, B: float, G: int, L: int) -> Counter:
    """B graphs of G slots scored against L text tokens."""
    p = m["planner"]
    D, I, H = p["hidden_size"], p["intermediate_size"], p["num_heads"]
    hi = ("bf16" if (p["use_bf16"] if p["nav_use_bf16"] is None
                     else p["nav_use_bf16"]) else "fp32")
    layer = (dense(B * G, D, D) * 2 + dense(B * L, D, D) * 2
             + attention(B, H, G, L, D // H)
             + dense(B * G, D, D) * 4 + attention(B, H, G, G, D // H)
             + dense(B * G, D, I) + dense(B * G, I, D))
    out = _w(hi, p["num_x_layers"] * layer)
    out += _w("fp32", dense(B * G, 7, D) + dense(B * G, D, D)
              + dense(B * G, D, 1))
    return out


def perceive(m: dict, B: float) -> Counter:
    """B panoramas: 12 views through CLIP and the depth ResNet, the
    waypoint heatmap, and the pano encoder over K + 12 tokens."""
    V = m["waypoint"]["num_images"]
    P = m["waypoint"]["max_predictions"] + V
    return clip(m, B * V) + depth(m, B * V) + waypoint(m, B) + pano(m, B, P)


def train_step(m: dict, B: int, T: int, G: int, L: int) -> Counter:
    """One learn step at its bucket: text (B, L), pano (B*T, K+12), nav
    (B*T, G, L); backward twice the forward's products for the trained
    stacks (the text stack only without `il.fix_lang_embedding`, the pano
    stack only without `il.fix_pano_embedding`)."""
    P = m["waypoint"]["max_predictions"] + m["waypoint"]["num_images"]
    t, pn, nv = text(m, B, L), pano(m, B * T, P), nav(m, B * T, G, L)
    out = t + pn + nv
    out += _scale(nv, 2.0)
    if not m["il"]["fix_lang_embedding"]:
        out += _scale(t, 2.0)
    if not m["il"]["fix_pano_embedding"]:
        out += _scale(pn, 2.0)
    return out


def _scale(c: Counter, k: float) -> Counter:
    return Counter({p: v * k for p, v in c.items()})


def seconds_at_peak(work: Work, peaks: Dict[str, float]) -> float:
    """The least time of `work` at the precisions' peaks."""
    return sum(v / peaks[p] for p, v in work.items())
