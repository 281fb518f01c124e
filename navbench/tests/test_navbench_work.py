"""The work counts of `navbench/work/model.py` against PyTorch's own
count of the plain reference's products (FlopCounterMode) at
tiny_config() shapes, and a hand count."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from navbench import model_config, weights
from navbench.reference.model import Drop, Ref
from navbench.work import model as work


@pytest.fixture(scope="module")
def tiny():
    from etpnav_tpu_torch.config import tiny_config
    from etpnav_tpu_torch.training.agent import AgentParams
    cfg = tiny_config()
    with torch.device("meta"):
        ap = AgentParams(cfg)
    table = [(n, tuple(t.shape)) for n, t in ap.state_dict().items()]
    m = model_config.model_block(cfg)
    return Ref(weights.make_weights(table, 3, torch.device("cpu")), m), m


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def total(c):
    return sum(c.values())


def test_hand_count_of_a_bert_layer():
    # B=2, L=5, D=8, I=16, H=2: q,k,v,o 4*2*10*8*8, attention 4*2*2*5*5*4,
    # FFN 2*2*10*8*16
    assert work.bert_layer(2, 5, 8, 16, 2) == (
        4 * 2 * 10 * 64 + 4 * 2 * 2 * 25 * 4 + 2 * 2 * 10 * 128)


def test_text_depth_waypoint_pano_nav(tiny):
    ref, m = tiny
    g = torch.Generator().manual_seed(0)
    B, L, G, P = 3, 16, 8, 17
    ids = torch.randint(5, 500, (B, L), generator=g)
    mask = torch.ones(B, L, dtype=torch.bool)
    with torch.no_grad():
        assert counted(lambda: ref.encode_text(ids, mask)) == \
            total(work.text(m, B, L))
        dep = torch.rand(B * 12, 64, 64, 1, generator=g)
        assert counted(lambda: ref.depth_trunk(dep)) == \
            total(work.depth(m, B * 12))
        dsp = ref.depth_trunk(dep)
        assert counted(lambda: ref.heatmap(dsp, B)) == \
            total(work.waypoint(m, B))
        rgb = torch.randn(B, P, 32, generator=g)
        dp = torch.randn(B, P, 16, generator=g)
        loc = torch.randn(B, P, 4, generator=g)
        nav = torch.zeros(B, P, dtype=torch.long)
        vm = torch.ones(B, P, dtype=torch.bool)
        assert counted(lambda: ref.pano(rgb, dp, loc, nav, vm)) == \
            total(work.pano(m, B, P))
        txt = torch.randn(B, L, 64, generator=g)
        args = (mask, torch.randn(B, G, 64, generator=g),
                torch.zeros(B, G, dtype=torch.long),
                torch.randn(B, G, 7, generator=g),
                torch.ones(B, G, dtype=torch.bool),
                torch.zeros(B, G, dtype=torch.bool),
                torch.rand(B, G, G, generator=g))
        assert counted(lambda: ref.score(txt, *args)) == \
            total(work.nav(m, B, G, L))


def test_clip_counts_the_class_row_of_the_last_block(tiny):
    ref, m = tiny
    c = m["clip"]
    n, W, H = 4, c["width"], c["heads"]
    T = (c["image_size"] // c["patch_size"]) ** 2 + 1
    rgb = torch.randint(0, 256, (n, 32, 32, 3), dtype=torch.uint8)
    with torch.no_grad():
        full = counted(lambda: ref.clip_image(rgb))
    # the reference runs all T rows of the last block
    all_rows = (work.dense(n * T, W, W) * 4
                + work.attention(n, H, T, T, W // H)
                + work.dense(n * T, W, 4 * W) * 2)
    cls_row = (work.dense(n, W, W) * 2 + work.dense(n * T, W, W) * 2
               + work.attention(n, H, 1, T, W // H)
               + work.dense(n, W, 4 * W) * 2)
    assert full - all_rows + cls_row == total(work.clip(m, n))


def test_precision_split(tiny):
    _, m = tiny
    assert set(work.perceive(m, 1)) == {"fp32"}     # tiny runs in fp32
    m2 = dict(m, planner=dict(m["planner"], use_bf16=True))
    p = work.perceive(m2, 1)
    assert p["bf16"] > 0 and p["fp32"] == total(work.waypoint(m2, 1)) + \
        total(work.pano(m2, 1, 17)) - work.pano(m2, 1, 17)["bf16"]


def test_learn_step_count_near_the_reference_backward(tiny):
    """Forward plus twice the forward for the backward: within 3% of
    the reference's counted learn step (its first layers take no input
    gradient, which the rule counts)."""
    ref, m = tiny
    g = torch.Generator().manual_seed(0)
    B, T, G, L, P = 2, 4, 16, 16, 17
    M = T * 5
    batch = {
        "txt_ids": torch.randint(5, 500, (B, L), generator=g),
        "txt_masks": torch.ones(B, L, dtype=torch.bool),
        "vp_rgb": torch.randn(B, T, P, 32, generator=g),
        "vp_dep": torch.randn(B, T, P, 16, generator=g),
        "vp_loc": torch.randn(B, T, P, 4, generator=g),
        "vp_nav": torch.zeros(B, T, P, dtype=torch.long),
        "vp_mask": torch.ones(B, T, P, dtype=torch.bool),
        "agg_node_step": torch.zeros(B, T, G, dtype=torch.long),
        "agg_ent_slot": torch.zeros(B, T, M, dtype=torch.long),
        "agg_ent_tok": torch.zeros(B, T, M, dtype=torch.long),
        "agg_ent_val": torch.zeros(B, T, M),
        "gmap_step_ids": torch.zeros(B, T, G, dtype=torch.long),
        "gmap_pos_fts": torch.randn(B, T, G, 7, generator=g),
        "gmap_mask": torch.ones(B, T, G, dtype=torch.bool),
        "gmap_visited": torch.zeros(B, T, G, dtype=torch.bool),
        "gmap_pair": torch.rand(B, T, G, G, generator=g),
        "teacher": torch.zeros(B, T, dtype=torch.long),
        "step_valid": torch.ones(B, T, dtype=torch.bool),
    }
    for k, v in ref.P.items():
        v.requires_grad_(k.startswith("planner."))
    try:
        got = counted(lambda: ref.il_loss(batch, Drop(), 1.0).backward())
    finally:
        for v in ref.P.values():
            v.requires_grad_(False)
            v.grad = None
    want = total(work.train_step(m, B, T, G, L))
    assert abs(got - want) / want < 0.03
