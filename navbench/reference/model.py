"""Plain reference of ETPNav's device programs, in fp32 PyTorch.

A frozen, independent statement of the model math that the benchmark
holds the program to. It imports neither the program nor JAX. Weights
are a flat {name: tensor} dict under the program's parameter names
(`navbench/weights.py` makes them from the seed); sizes come from the
configuration file's `model` block.

- `Ref.encode_text`       ids -> (B, L, D) text memory (BERT).
- `Ref.perceive`          12-view RGB-D -> CLIP ViT-B/32 and DD-PPO
                          ResNet-50 features, the waypoint heatmap, the
                          candidate slots (`nms_slots`), pano embeddings.
- `Ref.score`             padded graph tensors -> global logits.
- `Ref.il_loss`           the IL learn step's replay and cross-entropy,
                          with the same dropout draws as the program
                          (same generator, same order; attention dropout
                          by the Philox4x32-10 bits of `philox_keep`).

Published math, not the program's shortcuts: CLIP normalises the image
before the patch product and runs all 50 rows of its last block; GroupNorm
is `F.group_norm`; attention is softmax(q k^T / 8 + bias) v.

`mode="fp8"` is the control, the model computed one precision below the
configuration's bf16: every dense and convolution operand is rounded to
float8 e4m3 with a per-tensor scale (amax / 448) before an fp32
product, and its output is stored in e4m3 too, at the points where the
program rounds to bf16.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

NEG = -10000.0
E4M3_MAX = 448.0
DROP_ENV = 0.4
SAP_DROPOUT = 0.1

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# Philox4x32-10 constants
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def strict_fp32() -> None:
    """fp32 products stay fp32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, as fp32; the
    gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = amax / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


def _mulhilo(a: torch.Tensor, m: int):
    u = a * (m >> 16)
    t = a * (m & 0xFFFF)
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _MASK32
    return hi, lo


def philox_keep(seed_offset: torch.Tensor, B: int, H: int, Lq: int,
                Lk: int, p_drop: float) -> torch.Tensor:
    """Keep bits (B, H, Lq, Lk) of attention-prob dropout: element
    (b, h, q, k) is kept iff word k % 4 of Philox4x32-10 at counter
    (k // 4, q, b * H + h, offset) under key (seed low, seed high) is
    below floor(keep * 2^32)."""
    dev = seed_offset.device
    so = seed_offset.to(torch.int64)
    k0, k1 = so[0] & _MASK32, (so[0] >> 32) & _MASK32
    word = torch.arange(Lk, device=dev).view(1, 1, 1, Lk) % 4
    c0 = torch.arange(Lk, device=dev).view(1, 1, 1, Lk) // 4
    c1 = torch.arange(Lq, device=dev).view(1, 1, Lq, 1)
    c2 = (torch.arange(B, device=dev).view(B, 1, 1, 1) * H
          + torch.arange(H, device=dev).view(1, H, 1, 1))
    c3 = so[1] & _MASK32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    threshold = min(int((1.0 - p_drop) * 2.0 ** 32), _MASK32)
    bits = torch.where(word < 2, torch.where(word == 0, c0, c1),
                       torch.where(word == 2, c2, c3))
    return bits.expand(B, H, Lq, Lk) < threshold


class Drop:
    """The dropout stream of a training forward: hidden dropout draws
    `torch.rand` of the activation's shape, attention dropout one int64
    {seed, offset} pair, in the order the forward meets them. Without a
    generator every dropout is off."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.g = generator

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.g is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        u = torch.rand(x.shape, generator=self.g, device=x.device)
        return torch.where(u < keep, x / keep, 0.0)

    def attention_seed(self) -> Optional[torch.Tensor]:
        if self.g is None:
            return None
        return torch.randint(0, 2 ** 62, (2,), generator=self.g,
                             device=self.g.device, dtype=torch.int64)


class Ref:
    """The reference model over weights `P` and the configuration's
    `model` block `m`."""

    def __init__(self, P: Dict[str, torch.Tensor], m: dict,
                 mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"mode {mode!r}")
        self.P, self.m, self.fp8 = P, m, mode == "fp8"
        self.pl, self.clip, self.dep = m["planner"], m["clip"], m["depth"]
        self.wp = m["waypoint"]

    # -- primitives ---------------------------------------------------------

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return fake_e4m3(x) if self.fp8 else x

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.P[name + ".weight"], self.P[name + ".bias"]
        return self._q(self._q(x) @ self._q(w).t() + b)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._q(self._q(x) @ self._q(w))

    def ln(self, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"],
                            self.P[name + ".bias"], eps)

    def conv(self, name: str, x: torch.Tensor, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
        return self._q(F.conv2d(self._q(x),
                                self._q(self.P[name + ".weight"]),
                                stride=stride, padding=padding))

    def gn(self, name: str, x: torch.Tensor, groups: int) -> torch.Tensor:
        return F.group_norm(x, groups, self.P[name + ".weight"],
                            self.P[name + ".bias"], 1e-5)

    @staticmethod
    def gelu(x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x)                      # the exact erf form

    def attend(self, q_in, kv_in, heads: int, bias, qn: str, kn: str,
               vn: str, drop: Drop, p_attn: float) -> torch.Tensor:
        """Multi-head attention before the output projection:
        softmax(q k^T / sqrt(hd) + bias), dropped, times v."""
        B, Lq, D = q_in.shape
        Lk = kv_in.shape[1]
        hd = D // heads
        q = self.lin(qn, q_in).view(B, Lq, heads, hd).transpose(1, 2)
        k = self.lin(kn, kv_in).view(B, Lk, heads, hd).transpose(1, 2)
        v = self.lin(vn, kv_in).view(B, Lk, heads, hd).transpose(1, 2)
        so = drop.attention_seed() if p_attn > 0 else None
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if bias is not None:
            logits = logits + bias
        p = torch.softmax(logits, -1)
        if so is not None:
            keep = philox_keep(so, B, heads, Lq, Lk, p_attn)
            p = torch.where(keep, p / (1.0 - p_attn), 0.0)
        return (p @ v).transpose(1, 2).reshape(B, Lq, D)

    def attn_block(self, pre: str, x, ctx, heads: int, bias, eps: float,
                   drop: Drop, p_hidden: float, p_attn: float):
        """BERT attention sub-block: LN(x + drop(dense(MHA(x, ctx))))."""
        h = self.attend(x, ctx, heads, bias, pre + ".attn.q",
                        pre + ".attn.k", pre + ".attn.v", drop, p_attn)
        h = drop(self.lin(pre + ".out.dense", h), p_hidden)
        return self.ln(pre + ".out.ln", x + h, eps)

    def ffn(self, pre: str, x, eps: float, drop: Drop, p_hidden: float):
        h = self.gelu(self.lin(pre + ".intermediate", x))
        h = drop(self.lin(pre + ".output.dense", h), p_hidden)
        return self.ln(pre + ".output.ln", x + h, eps)

    def bert(self, pre: str, n: int, x, bias, heads: int, eps: float,
             drop: Drop, p_hidden: float = 0.0, p_attn: float = 0.0):
        for i in range(n):
            x = self.attn_block(f"{pre}.{i}.attention", x, x, heads, bias,
                                eps, drop, p_hidden, p_attn)
            x = self.ffn(f"{pre}.{i}.ffn", x, eps, drop, p_hidden)
        return x

    @staticmethod
    def mask_bias(mask: torch.Tensor) -> torch.Tensor:
        return (1.0 - mask.float()) * NEG

    # -- planner ------------------------------------------------------------

    def encode_text(self, ids: torch.Tensor, mask: torch.Tensor,
                    drop: Optional[Drop] = None) -> torch.Tensor:
        pl, drop = self.pl, drop or Drop()
        P = self.P
        L = ids.shape[1]
        x = (P["planner.embeddings.word_embeddings"][ids]
             + P["planner.embeddings.position_embeddings"][:L][None]
             + P["planner.embeddings.token_type_embeddings"][0])
        x = drop(self.ln("planner.embeddings.ln", x,
                         pl["lang_layer_norm_eps"]), pl["hidden_dropout"])
        bias = self.mask_bias(mask)[:, None, None, :]
        return self.bert("planner.lang_encoder", pl["num_l_layers"], x,
                         bias, pl["num_heads"], pl["lang_layer_norm_eps"],
                         drop, pl["hidden_dropout"], pl["attn_dropout"])

    def pano(self, rgb, dep, loc, nav, mask,
             drop: Optional[Drop] = None) -> torch.Tensor:
        """Pano token features (B, P, *) -> (B, P, D) embeddings."""
        pl, drop = self.pl, drop or Drop()
        eps = pl["vis_layer_norm_eps"]
        pre = "planner.img_embeddings"
        x = self.ln(f"{pre}.img_ln", self.lin(f"{pre}.img_linear", rgb), eps)
        x = x + self.ln(f"{pre}.dep_ln", self.lin(f"{pre}.dep_linear", dep),
                        eps)
        x = x + self.ln(f"{pre}.loc_ln", self.lin(f"{pre}.loc_linear", loc),
                        eps)
        x = x + self.P[f"{pre}.nav_type_embedding"][nav]
        x = x + self.P["planner.embeddings.token_type_embeddings"][1]
        x = drop(self.ln(f"{pre}.ln", x, eps), pl["hidden_dropout"])
        bias = self.mask_bias(mask)[:, None, None, :]
        ph, pa = pl["hidden_dropout"], pl["attn_dropout"]
        for i in range(pl["num_pano_layers"]):
            lp = f"{pre}.pano_encoder.layers.{i}"
            h = self.ln(f"{lp}.norm1", x, 1e-5)
            h = self.lin(f"{lp}.attn.o", self.attend(
                h, h, pl["num_heads"], bias, f"{lp}.attn.q", f"{lp}.attn.k",
                f"{lp}.attn.v", drop, pa))
            x = x + drop(h, ph)
            h = self.ln(f"{lp}.norm2", x, 1e-5)
            h = drop(self.gelu(self.lin(f"{lp}.linear1", h)), ph)
            x = x + drop(self.lin(f"{lp}.linear2", h), ph)
        return self.ln(f"{pre}.pano_encoder.final_ln", x, eps)

    def score(self, txt, txt_mask, img_fts, step_ids, pos_fts, gmask,
              visited, pair, drop: Optional[Drop] = None,
              embeds: bool = False):
        """Graph tensors -> (B, G) global logits, -inf at visited and
        padded slots (and the (B, G, D) graph embeddings with
        `embeds`)."""
        pl, drop = self.pl, drop or Drop()
        eps = pl["vis_layer_norm_eps"]
        ge = "planner.global_encoder"
        pos = self.ln(f"{ge}.gmap_pos_embeddings.ln",
                      self.lin(f"{ge}.gmap_pos_embeddings.dense", pos_fts),
                      eps)
        x = img_fts + self.P[f"{ge}.gmap_step_embeddings"][step_ids] + pos
        txt_bias = self.mask_bias(txt_mask)[:, None, None, :]
        w = self.P[f"{ge}.sprel_linear.weight"][0, 0]
        b = self.P[f"{ge}.sprel_linear.bias"][0]
        visn_bias = (self.mask_bias(gmask)[:, None, None, :]
                     + (pair * w + b)[:, None])
        ph, pa, H = pl["hidden_dropout"], pl["attn_dropout"], pl["num_heads"]
        for i in range(pl["num_x_layers"]):
            lp = f"{ge}.encoder.{i}"
            x = self.attn_block(f"{lp}.visual_attention", x, txt, H,
                                txt_bias, eps, drop, ph, pa)
            x = self.attn_block(f"{lp}.visn_self_att", x, x, H, visn_bias,
                                eps, drop, ph, pa)
            x = self.ffn(f"{lp}.visn_ffn", x, eps, drop, ph)
        h = F.relu(self.lin("planner.global_sap_head.dense1", x))
        h = drop(self.ln("planner.global_sap_head.ln", h, eps), SAP_DROPOUT)
        logits = self.lin("planner.global_sap_head.dense2", h)[..., 0]
        ninf = torch.full_like(logits, float("-inf"))
        logits = torch.where(visited, ninf, logits)
        logits = torch.where(gmask, logits, ninf)
        return (logits, x) if embeds else logits

    # -- perception ---------------------------------------------------------

    def clip_image(self, rgb: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> (N, output_dim) CLIP image embeddings."""
        c = self.clip
        dev = rgb.device
        mean = torch.tensor(CLIP_MEAN, device=dev)
        std = torch.tensor(CLIP_STD, device=dev)
        x = (rgb.float() / 255.0 - mean) / std
        N, Hh, W, _ = x.shape
        ps = c["patch_size"]
        x = x.reshape(N, Hh // ps, ps, W // ps, ps, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(N, -1, ps * ps * 3)
        x = self.mm(x, self.P["clip.patch_embed"])
        cls = self.P["clip.class_embedding"].expand(N, 1, -1)
        x = torch.cat([cls, x], 1) + self.P["clip.positional_embedding"]
        eps = c["layer_norm_eps"]
        x = self.ln("clip.ln_pre", x, eps)
        nodrop = Drop()
        for i in range(c["layers"]):
            b = f"clip.blocks.{i}"
            a = self.ln(f"{b}.ln_1", x, eps)
            x = x + self.lin(f"{b}.attn.o", self.attend(
                a, a, c["heads"], None, f"{b}.attn.q", f"{b}.attn.k",
                f"{b}.attn.v", nodrop, 0.0))
            h = self.lin(f"{b}.mlp_fc", self.ln(f"{b}.ln_2", x, eps))
            x = x + self.lin(f"{b}.mlp_proj", h * torch.sigmoid(1.702 * h))
        return self.mm(self.ln("clip.ln_post", x[:, 0], eps),
                       self.P["clip.proj"])

    def depth_trunk(self, depth: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 1) in [0, 1] -> (N, s, s, C) ResNet-50 features."""
        d = self.dep
        g = d["ngroups"]
        x = depth.float().permute(0, 3, 1, 2)
        x = F.relu(self.gn("depth.stem_gn",
                           self.conv("depth.stem_conv", x, 2, 3), g))
        x = F.max_pool2d(x, 3, 2, 1)
        for li, blocks in enumerate(d["layers"]):
            for bi in range(blocks):
                b = f"depth.layer{li + 1}.{bi}"
                stride = (1 if li == 0 else 2) if bi == 0 else 1
                h = F.relu(self.gn(f"{b}.gn1", self.conv(f"{b}.conv1", x), g))
                h = F.relu(self.gn(f"{b}.gn2",
                                   self.conv(f"{b}.conv2", h, stride, 1), g))
                h = self.gn(f"{b}.gn3", self.conv(f"{b}.conv3", h), g)
                if f"{b}.down_conv.weight" in self.P:
                    x = self.gn(f"{b}.down_gn",
                                self.conv(f"{b}.down_conv", x, stride), g)
                x = F.relu(h + x)
        x = self.conv("depth.compression_conv", x, 1, 1)
        x = F.relu(self.gn("depth.compression_gn", x, 1))
        return x.permute(0, 2, 3, 1)

    def heatmap(self, dep_spatial: torch.Tensor, B: int) -> torch.Tensor:
        """(B*12, s, s, C) depth features -> (B, 120, 12) waypoint logits,
        each image rotated to the middle of its sector."""
        w = self.wp
        V = w["num_images"]
        s, c = dep_spatial.shape[1], dep_spatial.shape[-1]
        chw = dep_spatial.permute(0, 3, 1, 2).reshape(B, V, c * s * s)
        cw = torch.cat([chw[:, :1], chw[:, 1:].flip(1)], 1)  # clockwise
        x = F.relu(self.lin("waypoint.visual_fc_depth", cw))
        idx = torch.arange(V, device=x.device)
        diff = (idx[:, None] - idx[None, :]).abs()
        near = torch.minimum(diff, V - diff) <= w["neighbor"]
        bias = self.mask_bias(near)[None, None]
        x = self.bert("waypoint.waypoint_trm", w["num_layers"], x, bias,
                      w["num_heads"], w["layer_norm_eps"], Drop())
        h = self.lin("waypoint.vis_classifier.dense2",
                     F.relu(self.lin("waypoint.vis_classifier.dense1", x)))
        logits = h.reshape(B, w["num_angles"], w["num_distances"])
        return torch.roll(logits, -w["heatmap_offset"], dims=1)

    def perceive(self, rgb: torch.Tensor, depth: torch.Tensor,
                 slots: Optional[dict] = None) -> dict:
        """(B, 12, H, W, 3) uint8 and (B, 12, Hd, Wd, 1) -> features,
        heatmap, candidate slots and pano embeddings. `slots` (from
        `nms_slots`) fixes the candidates; by default they come from this
        model's own heatmap."""
        B, V = rgb.shape[:2]
        rgb_f = self.clip_image(rgb.reshape((B * V,) + rgb.shape[2:]))
        rgb_f = rgb_f.reshape(B, V, -1)
        dsp = self.depth_trunk(depth.reshape((B * V,) + depth.shape[2:]))
        heat = self.heatmap(dsp, B)
        if slots is None:
            slots = nms_slots(heat, self.wp["max_predictions"],
                              tuple(self.wp["nms_sigma"]))
        c = dsp.shape[-1]
        dep_pooled = dsp.reshape(B, V, -1, c).mean(2)
        angle_idx, dist_idx, valid = (slots["angle_idx"], slots["dist_idx"],
                                      slots["valid"])
        img_idx = (12 - (angle_idx + 5) // 10) % 12
        angles_cw = angle_idx.float() / self.wp["num_angles"] * 2 * math.pi
        z = torch.zeros_like(angles_cw)
        cand_loc = torch.stack([angles_cw.sin(), angles_cw.cos(), z.sin(),
                                z.cos()], -1)
        cand_rgb = torch.gather(rgb_f, 1, img_idx[..., None].expand(
            -1, -1, rgb_f.shape[-1]))
        cand_dep = torch.gather(dep_pooled, 1,
                                img_idx[..., None].expand(-1, -1, c))
        ang = (1.0 - torch.arange(V, device=rgb.device, dtype=torch.float64)
               / 12.0) * 2.0 * math.pi
        zv = torch.zeros_like(ang)
        pano_loc = torch.stack([ang.sin(), ang.cos(), zv.sin(), zv.cos()],
                               -1).float()
        # a view is covered when a valid candidate points into it
        hit = (img_idx[..., None] == torch.arange(V, device=rgb.device)) \
            & valid[..., None]
        covered = hit.any(1)
        feats = {
            "rgb": torch.cat([cand_rgb, rgb_f], 1),
            "dep": torch.cat([cand_dep, dep_pooled], 1),
            "loc": torch.cat([cand_loc, pano_loc[None].expand(B, V, 4)], 1),
            "nav": torch.cat([valid.long(),
                              torch.zeros(B, V, dtype=torch.long,
                                          device=rgb.device)], 1),
            "mask": torch.cat([valid, ~covered], 1),
        }
        emb = self.pano(feats["rgb"], feats["dep"], feats["loc"],
                        feats["nav"], feats["mask"])
        m = feats["mask"][..., None].float()
        avg = (emb * m).sum(1) / m.sum(1).clamp_min(1e-6)
        return {"heatmap": heat, "slots": slots, "pano_embeds": emb,
                "avg_pano_embeds": avg, "pano_masks": feats["mask"],
                "img_idx": img_idx}

    # -- IL learn step ------------------------------------------------------

    def replay_logits(self, batch: dict, drop: Drop) -> torch.Tensor:
        """The learn step's replay over every recorded step: text, the
        env dropout on the RGB features, pano tokens, their recorded
        aggregation into graph nodes, navigation. -> (B, T, G)."""
        B, T, Pt = batch["vp_rgb"].shape[:3]
        G = batch["gmap_mask"].shape[2]
        txt = self.encode_text(batch["txt_ids"], batch["txt_masks"], drop)
        rgb = drop(batch["vp_rgb"], DROP_ENV)
        emb = self.pano(rgb.reshape(B * T, Pt, -1),
                        batch["vp_dep"].reshape(B * T, Pt, -1),
                        batch["vp_loc"].reshape(B * T, Pt, -1),
                        batch["vp_nav"].reshape(B * T, Pt),
                        batch["vp_mask"].reshape(B * T, Pt), drop)
        tok = emb.reshape(B, T, Pt, -1) * batch["step_valid"][..., None,
                                                               None]
        img = aggregate(batch, tok)
        L = txt.shape[1]
        nav = self.score(
            txt[:, None].expand(B, T, L, -1).reshape(B * T, L, -1),
            batch["txt_masks"][:, None].expand(B, T, L).reshape(B * T, L),
            img.reshape(B * T, G, -1),
            batch["gmap_step_ids"].reshape(B * T, G),
            batch["gmap_pos_fts"].reshape(B * T, G, -1),
            batch["gmap_mask"].reshape(B * T, G),
            batch["gmap_visited"].reshape(B * T, G),
            batch["gmap_pair"].reshape(B * T, G, G), drop)
        return nav.reshape(B, T, G)

    def il_loss(self, batch: dict, drop: Drop, ml_weight: float,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-entropy of the replayed logits against the teacher
        (-100 ignored), over the live steps' count. `rows` keeps only
        those batch rows (a fault reading: half the batch left out)."""
        logits = self.replay_logits(batch, drop)
        teacher = batch["teacher"]
        live = batch["step_valid"]
        if rows is not None:
            keep = torch.zeros_like(live)
            keep[rows] = True
            live = live & keep
        valid = (teacher >= 0) & live
        logp = torch.log_softmax(
            torch.where(torch.isfinite(logits), logits, -1e9), -1)
        nll = -logp.gather(-1, teacher.clamp_min(0)[..., None])[..., 0]
        return ml_weight * torch.where(valid, nll, 0.0).sum() / \
            live.sum().clamp_min(1)


def aggregate(batch: dict, tok: torch.Tensor) -> torch.Tensor:
    """(B, T, P, D) pano tokens -> (B, T, G, D) graph node features by
    the recorded provenance: a node slot averages its visit step's valid
    tokens, a ghost slot sums its weighted (step, token) entries."""
    B, T, Pt, D = tok.shape
    G = batch["agg_node_step"].shape[2]
    vmask = batch["vp_mask"] & batch["step_valid"][..., None]
    cnt = vmask.sum(-1).clamp_min(1).float()
    step_mean = (tok * vmask[..., None]).sum(2) / cnt[..., None]  # B,T,D
    node = batch["agg_node_step"]                                  # B,T,G
    has = node >= 0
    picked = torch.gather(
        step_mean[:, None].expand(B, T, T, D), 2,
        node.clamp_min(0)[..., None].expand(B, T, G, D))
    out = torch.where(has[..., None], picked, 0.0)
    flat = tok.reshape(B, T * Pt, D)
    ent = torch.gather(flat[:, None].expand(B, T, T * Pt, D), 2,
                       batch["agg_ent_tok"][..., None].expand(-1, -1, -1, D))
    ent = ent * batch["agg_ent_val"][..., None]
    ghost = torch.zeros_like(out).scatter_add_(
        2, batch["agg_ent_slot"][..., None].expand(-1, -1, -1, D), ent)
    return out + ghost


def nms_slots(heat: torch.Tensor, k: int, sigma) -> dict:
    """The waypoint candidates of a (B, A, D) heatmap: softmax over all
    cells (an exact fixed-point sum), the angle rows wrapped, then k
    rounds of argmax (ties to the lowest flat index) and suppression of
    |dy| <= sigma_y, min(|dx|, |dx + W|) <= sigma_x; the surviving peaks
    listed in row-major order. -> angle_idx, dist_idx, valid (B, k)."""
    B, A, D = heat.shape
    x = heat.reshape(B, A * D).float()
    e = torch.exp(x - x.amax(1, keepdim=True))
    fixed = (e * 2.0 ** 40).to(torch.int64).sum(1, keepdim=True)
    prob = (e / (fixed.double() / 2.0 ** 40).float()).reshape(B, A, D)
    wrapped = torch.cat([prob[:, -1:], prob, prob[:, :1]], 1)
    Hh, W = A + 2, D
    flat = wrapped.reshape(B, -1)
    supp = flat.clone()
    out = torch.zeros_like(flat)
    rows = torch.arange(B, device=heat.device)
    xs = torch.arange(W, device=heat.device, dtype=torch.float32)
    ys = torch.arange(Hh, device=heat.device, dtype=torch.float32)
    for _ in range(k):
        ix = torch.argmax(supp, 1)
        out[rows, ix] = flat[rows, ix]
        dx = xs[None, None, :] - (ix % W).float()[:, None, None]
        dy = ys[None, :, None] - (ix // W).float()[:, None, None]
        dx = torch.minimum(dx.abs(), (dx + W).abs())
        hit = (dx <= sigma[0]) & (dy.abs() <= sigma[1])
        supp = supp * (1.0 - hit.float().reshape(B, -1))
    nms = out.clamp_min(0.0).reshape(B, Hh, W)[:, 1:-1]
    pos = torch.arange(A * D, device=heat.device)
    key = torch.where(nms.reshape(B, -1) > 0, pos[None],
                      torch.full_like(pos, A * D)[None])
    key = torch.sort(key, 1).values[:, :k]
    valid = key < A * D
    idx = torch.where(valid, key, torch.zeros_like(key))
    return {"angle_idx": idx // D, "dist_idx": idx % D, "valid": valid}
