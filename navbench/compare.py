"""The comparisons that decide `correct`: what the timed path produced,
held against the plain reference run once the window has closed, the
program's state freed, on the same inputs and the same seeded weights.

The reference is the module the configuration file names under
`reference` (`common.modules`; by default `navbench/reference/model.py`),
which the caller passes in. It provides:

- `Ref(P, m, mode="fp32")`: the model over the weights `P` (the
  program's parameter names) and the file's `model` block `m`;
  `mode="fp8"` is the control. `compare` calls its `encode_text(ids,
  mask)`, `perceive(rgb, depth, slots=None)`, `score(txt, txt_mask,
  img_fts, step_ids, pos_fts, mask, visited, pair, embeds=True)` and
  `il_loss(batch, drop, ml_weight, rows)`;
- `Drop(generator=None)`: the dropout stream `il_loss` draws from.

A new architecture's module subclasses `navbench.reference.model.Ref`
and overrides what differs. `nms_slots` and `strict_fp32` hold for every
architecture and come from `navbench/reference/model.py`.

Every number is a widest gap, so larger is worse; each cell's limits are
in `navbench/limits/<cell>.json`. `other` ("fp8") puts the reference in
the program's place at the precision below the configuration's: the
control, which has to read above a limit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from navbench import weights
from navbench.reference.model import nms_slots, strict_fp32


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return x


def host_records(records: list) -> list:
    """The kept batches with every program tensor copied to the host."""
    out = []
    for r in records:
        h = dict(r)
        h["wp"] = {k: _np(v) for k, v in r["wp"].items()}
        h["logits"] = _np(r["logits"])
        h["gmap_embeds"] = _np(r["gmap_embeds"])
        out.append(h)
    return out


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|: the widest gap against the
    reference's scale."""
    if got.shape != want.shape:
        return math.inf
    scale = float(want.abs().max())
    if scale == 0.0:
        return 0.0 if float(got.abs().max()) == 0.0 else math.inf
    return float((got.float() - want.float()).abs().max()) / scale


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||."""
    if got.shape != want.shape:
        return math.inf
    scale = float(want.float().norm())
    if scale == 0.0:
        return 0.0 if float(got.float().norm()) == 0.0 else math.inf
    return float((got.float() - want.float()).norm()) / scale


def logit_gaps(got: torch.Tensor, want: torch.Tensor):
    """(relative L2 gap over the reference's finite logits, the widest
    gap by which the logit of the slot `got` ranks first lies below the
    reference's best). Slots finite on one side only fail both."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return math.inf, math.inf
    rel = rel_l2(got[fin], want[fin])
    pick = torch.where(fin, got, -math.inf).argmax(-1)
    best = torch.where(fin, want, -math.inf).amax(-1)
    chosen = want.gather(-1, pick[:, None])[:, 0]
    return rel, float((best - chosen).max())


def _fit(tokens: np.ndarray, L: int, pad: int) -> np.ndarray:
    out = np.full(L, pad, np.int64)
    n = min(len(tokens), L)
    out[:n] = tokens[:n]
    return out


def serve_readings(reference, records: list,
                   tokens: Dict[int, np.ndarray], table, m: dict,
                   weight_seed: int, device, L: int, pad: int,
                   other: Optional[str] = None) -> dict:
    """The serving numbers over the kept batches, by the reference module
    `reference`. Without `other` they judge the program's outputs; with
    `other="fp8"` the control's, made from the same inputs.

    - txt_rel:      each row's text memory over its valid tokens
                    (relative L2; the widest gap there is set by a few
                    LayerNorm rows of near-constant input, where bf16
                    and fp8 part alike);
    - heatmap_rel:  the waypoint heatmap of the live rows;
    - nms_mismatch: rows whose candidate slots differ from the
                    reference's selection on the program's own heatmap
                    (exact; the program only);
    - pano_rel:     pano embeddings of the valid tokens, the reference's
                    computed at the candidates selected on the judged
                    side's heatmap;
    - nav_rel, action_gap: the scoring on the program's graph tensors
                    (the host map's output), each side with its own text
                    memory: the live slots' graph embeddings, one
                    relative L2 gap over all kept batches; and the
                    widest gap by which the logit of the slot the judged
                    side ranks first lies below the reference's best
                    (infinite where the two sides' finite logits
                    differ). The logits' own relative gap separates the
                    bf16 program from the fp8 control by 2x only on this
                    sample, so it is not one of the numbers."""
    strict_fp32()
    P = weights.make_weights(table, weight_seed, device)
    ref = reference.Ref(P, m)
    ctl = reference.Ref(P, m, other) if other else None
    w = m["waypoint"]
    K, sigma = w["max_predictions"], tuple(w["nms_sigma"])
    out = {"txt_rel": 0.0, "heatmap_rel": 0.0, "pano_rel": 0.0,
           "action_gap": 0.0}
    # the graph embeddings of every kept batch, gathered for one
    # relative L2 gap over the sample; the finite logits' pattern
    lg_got, em_got, em_want = [], [], []
    if ctl is None:
        out["nms_mismatch"] = 0.0
    texts = {}

    def text_of(sid, model):
        key = (sid, model is ctl)
        if key not in texts:
            ids = torch.from_numpy(_fit(tokens[sid], L, pad))[None].to(
                device)
            texts[key] = model.encode_text(ids, ids != pad)[0]
        return texts[key]

    def t(x, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return x if dtype is None else x.to(dtype)

    with torch.no_grad():
        for r in records:
            n = r["n"]
            rgb, dep = t(r["rgb"][:n]), t(r["depth"][:n])
            if ctl is None:
                heat = t(r["wp"]["heatmap"][:n])
                slots = nms_slots(heat, K, sigma)
                want = ref.perceive(rgb, dep, slots)
                ang = 2 * math.pi - (slots["angle_idx"].float()
                                     / w["num_angles"] * 2 * math.pi)
                dist = (slots["dist_idx"].float() + 1.0) * 0.25
                v = slots["valid"]
                same = ((v == t(r["wp"]["cand_valid"][:n]))
                        & (~v | ((ang == t(r["wp"]["cand_angles"][:n]))
                                 & (dist == t(r["wp"]["cand_distances"]
                                              [:n])))))
                out["nms_mismatch"] += float((~same.all(1)).sum())
                got_pano = t(r["wp"]["pano_embeds"][:n])
                got_mask = t(r["wp"]["pano_masks"][:n])
            else:
                got = ctl.perceive(rgb, dep)
                heat, got_pano, got_mask = (got["heatmap"],
                                            got["pano_embeds"],
                                            got["pano_masks"])
                want = ref.perceive(rgb, dep, got["slots"])
            out["heatmap_rel"] = max(out["heatmap_rel"],
                                     rel_gap(heat, want["heatmap"]))
            if torch.equal(got_mask, want["pano_masks"]):
                mk = want["pano_masks"]
                gap = rel_gap(got_pano[mk], want["pano_embeds"][mk])
            else:
                gap = math.inf
            out["pano_rel"] = max(out["pano_rel"], gap)
            ref_txt, got_txt = [], []
            for i, sid in enumerate(r["sids"]):
                rt = text_of(sid, ref)
                gt = (t(r["txt"][i]) if ctl is None else text_of(sid, ctl))
                mk = t(r["txt_mask"][i])
                out["txt_rel"] = max(out["txt_rel"],
                                     rel_l2(gt[mk], rt[mk]))
                ref_txt.append(rt)
                got_txt.append(gt)
            g = r["gmap"]
            args = (t(r["txt_mask"]).bool(),
                    t(g["img_fts"][:n]), t(g["step_ids"][:n], torch.long),
                    t(g["pos_fts"][:n]), t(g["mask"][:n]),
                    t(g["visited"][:n]), t(g["pair_dists"][:n]))
            want_l, want_e = ref.score(torch.stack(ref_txt), *args,
                                       embeds=True)
            if ctl is None:
                got_l = t(r["logits"][:n])
                got_e = t(r["gmap_embeds"][:n])
            else:
                got_l, got_e = ctl.score(torch.stack(got_txt), *args,
                                         embeds=True)
            fin = torch.isfinite(want_l)
            if not torch.equal(fin, torch.isfinite(got_l)):
                lg_got.append(torch.full((1,), math.inf, device=device))
            _, gap = logit_gaps(got_l, want_l)
            out["action_gap"] = max(out["action_gap"], gap)
            live = args[4]
            em_got.append(got_e[live])
            em_want.append(want_e[live])
    out["nav_rel"] = rel_l2(torch.cat(em_got), torch.cat(em_want))
    if any(not torch.isfinite(x).all() for x in lg_got):
        out["action_gap"] = math.inf
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keep=None) -> float:
    """The worst leaf's |got norm - want norm|, against the larger of
    that leaf's reference norm and the median leaf's."""
    names = [k for k in want if keep is None or k in keep]
    if not names or set(names) - set(got):
        return math.inf
    med = float(np.median([want[k] for k in names]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in names)


def train_reference(reference, batches: list, rollout: list, table,
                    m: dict, weight_seed: int, dropout_seed: int, device,
                    mode: str = "fp32", half: bool = False,
                    window: Optional[dict] = None) -> dict:
    """The learn steps of the reference module `reference` over the
    program's first three recorded batches, from the seeded weights,
    with the trainer's dropout stream, AdamW as configured: each step's
    loss, the first gradient's norm per planner leaf, each leaf's change
    after the steps; and, for the first rollout's scoring, the graph
    embeddings of each of its steps from the initial weights, on the
    graph tensors the rollout's host map made, with the reference's own
    text memory of the recorded instructions. `half` leaves out the
    second half of each batch's rows (a fault reading). AdamW as the
    configuration states it: betas 0.9 / 0.999, eps 1e-8, decay 1e-4
    (optax.adamw's defaults, which the trainer takes). With `window`,
    also the window's kept iteration (`window_reference`)."""
    strict_fp32()
    P = weights.make_weights(table, weight_seed, device)
    names = [k for k in P if k.startswith("planner.")]
    il = m["il"]
    frozen = set()
    if il["fix_lang_embedding"]:
        frozen |= {"planner.embeddings.", "planner.lang_encoder."}
    if il["fix_pano_embedding"]:
        frozen |= {"planner.img_embeddings."}
    train = [k for k in names if not any(k.startswith(f) for f in frozen)]
    ref = reference.Ref(P, m, mode)
    out = {"rollout_embeds": []}
    with torch.no_grad():
        b0 = _to_batch(batches[0], device)
        txt = ref.encode_text(b0["txt_ids"], b0["txt_masks"])
        for r in rollout:
            g = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in r["gmap"].items()}
            _, emb = ref.score(txt, b0["txt_masks"], g["img_fts"],
                               g["step_ids"].long(), g["pos_fts"],
                               g["mask"], g["visited"], g["pair_dists"],
                               embeds=True)
            out["rollout_embeds"].append(emb.cpu().numpy())
    p0 = {k: P[k].detach().clone() for k in train}
    for k in train:
        P[k].requires_grad_(True)
    adam = {k: (torch.zeros_like(P[k]), torch.zeros_like(P[k]))
            for k in train}
    drop = reference.Drop(
        torch.Generator(device=device).manual_seed(dropout_seed))
    losses = []
    for step, rec in enumerate(batches):
        b = _to_batch(rec, device)
        rows = None
        if half:
            rows = torch.arange(b["teacher"].shape[0] // 2, device=device)
        for k in train:
            P[k].grad = None
        loss = ref.il_loss(b, drop, il["ml_weight"], rows)
        loss.backward()
        if step == 0:
            out["grad"] = {k: float(P[k].grad.norm()) if P[k].grad is not None
                           else 0.0 for k in train}
        adamw(P, adam, train, step + 1, il["lr"])
        losses.append(loss.item())
    out["loss"] = losses
    out["change"] = {k: float((P[k].detach() - p0[k]).norm())
                     for k in train}
    if window is not None:
        del p0, adam
        for k in train:
            P[k].requires_grad_(False)
            P[k].grad = None
        out["window"] = window_reference(reference, window, P, m, train,
                                         device, mode, half)
    return out


def window_reference(reference, win: dict, P: dict, m: dict, train: list,
                     device, mode: str = "fp32", half: bool = False) -> dict:
    """The reference module `reference` over one iteration of the
    window, from the trained leaves as the program held them when it
    started (`win["params"]`: the program's state, which the reference
    can only follow; the start is checked by `train_reference`'s own
    steps): the graph embeddings of its rollout's steps on the rollout's
    graph tensors, with the reference's text memory of the iteration's
    instructions, and its learn step's loss and each leaf's gradient
    norm, with the dropout stream from the state the program's generator
    held."""
    Pw = dict(P)
    for k in train:
        Pw[k] = win["params"][k].detach().float().clone().requires_grad_(
            True)
    ref = reference.Ref(Pw, m, mode)
    b = _to_batch(win["batch"], device)
    out = {"rollout_embeds": []}
    with torch.no_grad():
        txt = ref.encode_text(b["txt_ids"], b["txt_masks"])
        for r in win["rollout"]:
            g = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in r["gmap"].items()}
            _, emb = ref.score(txt, b["txt_masks"], g["img_fts"],
                               g["step_ids"].long(), g["pos_fts"],
                               g["mask"], g["visited"], g["pair_dists"],
                               embeds=True)
            out["rollout_embeds"].append(emb.cpu().numpy())
    gen = torch.Generator(device=device)
    gen.set_state(win["dropout"])
    rows = (torch.arange(b["teacher"].shape[0] // 2, device=device)
            if half else None)
    loss = ref.il_loss(b, reference.Drop(gen), m["il"]["ml_weight"], rows)
    loss.backward()
    out["loss"] = loss.item()
    out["grad"] = {k: float(Pw[k].grad.norm()) if Pw[k].grad is not None
                   else 0.0 for k in train}
    return out


@torch.no_grad()
def adamw(P: dict, state: dict, names, t: int, lr: float,
          betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 1e-4) -> None:
    """One AdamW step (decoupled weight decay, bias-corrected moments) on
    the leaves `names` of P, in place."""
    b1, b2 = betas
    for k in names:
        g = P[k].grad
        if g is None:
            continue
        m, v = state[k]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        P[k].mul_(1 - lr * weight_decay)
        denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
        P[k].addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def _to_batch(rec: dict, device) -> dict:
    b = {}
    for k, v in rec.items():
        if k == "logits":
            continue
        x = torch.from_numpy(np.ascontiguousarray(v))
        if x.dtype in (torch.int32, torch.int16):
            x = x.long()
        b[k] = x.to(device)
    return b


def _nav_rel(got_rollout: list, want_embeds: list) -> float:
    """The rollout's graph embeddings of its live slots, one relative L2
    gap over all its steps."""
    got_e = [torch.from_numpy(r["embeds"][r["gmap"]["mask"]])
             for r in got_rollout]
    want_e = [torch.from_numpy(e[r["gmap"]["mask"]])
              for r, e in zip(got_rollout, want_embeds)]
    return (rel_l2(torch.cat(got_e), torch.cat(want_e))
            if got_e and len(got_e) == len(want_e) else math.inf)


def window_readings(prog: dict, want: dict) -> dict:
    """The window's kept iteration: its learn step's loss (relative
    gap), its gradient's norm by the worst leaf (the leaves of
    `leaf_gap`), and its rollout's graph embeddings."""
    return {"loss_gap": abs(prog["loss"] - want["loss"])
            / max(abs(want["loss"]), 1e-30),
            "grad_gap": leaf_gap(prog["grad"], want["grad"]),
            "rollout_nav_rel": _nav_rel(prog["rollout"],
                                        want["rollout_embeds"])}


def train_readings(prog: dict, want: dict) -> dict:
    """The training numbers: each step's loss (worst relative gap), the
    first gradient's norm by the worst leaf, each leaf's change after
    the steps by the worst leaf (leaves whose reference gradient is under
    a thousandth of the median leaf's left out: they move by round-off
    alone), and the first rollout's graph embeddings of its live slots,
    one relative L2 gap over all its steps (`rollout_nav_rel`; the
    rollout's logits separate the bf16 program from the fp8 control by
    under 3x on RxR, as the serving logits do). Where both sides carry
    the window's kept iteration, loss_gap and rollout_nav_rel are each
    the larger of set-up's reading and the window's, and a side without
    it fails. The window's gradient gap is not one of the numbers: the
    only fault read at the cells' size, the half batch, reads under ten
    times it (PERF.md)."""
    lg = [abs(a - b) / max(abs(b), 1e-30)
          for a, b in zip(prog["loss"], want["loss"])]
    g = want["grad"]
    med = float(np.median(list(g.values())))
    keep = {k for k, v in g.items() if v >= 1e-3 * med}
    out = {"loss_gap": max(lg) if lg else math.inf,
           "grad_gap": leaf_gap(prog["grad"], g),
           "change_gap": leaf_gap(prog["change"], want["change"], keep),
           "rollout_nav_rel": _nav_rel(prog["rollout"],
                                       want["rollout_embeds"])}
    if "window" in prog or "window" in want:
        w = (window_readings(prog["window"], want["window"])
             if "window" in prog and "window" in want
             else dict.fromkeys(("loss_gap", "rollout_nav_rel"), math.inf))
        for k in ("loss_gap", "rollout_nav_rel"):
            out[k] = max(out[k], w[k])
    return out
