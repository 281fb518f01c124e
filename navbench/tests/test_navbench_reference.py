"""The plain reference against the port at tiny_config() on the CPU
(fp32, the port's plain versions of its kernels): the same seeded
weights and inputs give the same outputs, dropout draws included."""

import dataclasses

import numpy as np
import pytest
import torch

from navbench import compare, model_config, program, weights
from navbench.reference import model as reference
from navbench.reference.model import Drop, Ref, nms_slots

DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    from etpnav_tpu_torch.config import tiny_config
    from etpnav_tpu_torch.training.agent import Agent
    cfg = tiny_config()
    params, table = program.agent_params(cfg, 123, DEV)
    agent = Agent(cfg, params, device="cpu")
    m = model_config.model_block(cfg)
    ref = Ref(weights.make_weights(table, 123, DEV), m)
    return cfg, agent, ref, table, m


def test_weights_are_the_seeds(setup):
    _, _, _, table, _ = setup
    a = weights.make_weights(table, 5, DEV)
    b = weights.make_weights(table, 5, DEV)
    c = weights.make_weights(table, 6, DEV)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert weights.kind("planner.lang_encoder.0.ffn.output.ln.weight",
                        (64,)) == "norm_scale"
    assert weights.kind("depth.layer1.0.gn1.bias", (8,)) == "norm_shift"
    assert weights.kind("depth.stem_conv.weight", (8, 1, 7, 7)) == "conv"
    assert weights.kind("planner.img_embeddings.img_linear.bias",
                        (64,)) == "dense"


def test_perceive_text_and_scoring(setup):
    cfg, agent, ref, _, _ = setup
    g = torch.Generator().manual_seed(0)
    B = 3
    rgb = torch.randint(0, 256, (B, 12, 32, 32, 3), generator=g,
                        dtype=torch.uint8)
    dep = torch.rand(B, 12, 64, 64, 1, generator=g)
    got = agent.perceive(rgb, dep)
    slots = nms_slots(got["heatmap"], cfg.waypoint.max_predictions,
                      cfg.waypoint.nms_sigma)
    assert torch.equal(slots["valid"], got["cand_valid"])
    want = ref.perceive(rgb, dep, slots)
    assert torch.equal(want["img_idx"], got["cand_img_idx"])
    assert compare.rel_gap(got["heatmap"], want["heatmap"]) < 1e-4
    mk = want["pano_masks"]
    assert torch.equal(mk, got["pano_masks"])
    assert compare.rel_gap(got["pano_embeds"][mk],
                           want["pano_embeds"][mk]) < 1e-4
    ids = torch.randint(5, 500, (B, 16), generator=g)
    mask = torch.ones(B, 16, dtype=torch.bool)
    mask[:, 10:] = False
    ids[~mask] = 0
    t_got, t_want = agent.encode_text(ids, mask), ref.encode_text(ids, mask)
    assert compare.rel_l2(t_got[mask], t_want[mask]) < 1e-5
    G = 8
    gm = {"img_fts": torch.randn(B, G, 64, generator=g),
          "step_ids": torch.randint(0, 5, (B, G), generator=g),
          "pos_fts": torch.randn(B, G, 7, generator=g),
          "mask": torch.ones(B, G, dtype=torch.bool),
          "visited": torch.zeros(B, G, dtype=torch.bool),
          "pair_dists": torch.rand(B, G, G, generator=g)}
    gm["mask"][:, 6:] = False
    gm["visited"][:, 1] = True
    out = agent.score_navigation(t_got, mask, gm)
    lw, ew = ref.score(t_want, mask, gm["img_fts"], gm["step_ids"],
                       gm["pos_fts"], gm["mask"], gm["visited"],
                       gm["pair_dists"], embeds=True)
    rel, gap = compare.logit_gaps(out["global_logits"], lw)
    assert rel < 1e-5 and gap == 0.0
    assert compare.rel_l2(out["gmap_embeds"][gm["mask"]],
                          ew[gm["mask"]]) < 1e-5


def test_fp8_control_parts_from_fp32(setup):
    cfg, _, ref, _, m = setup
    ctl = Ref(ref.P, m, "fp8")
    g = torch.Generator().manual_seed(1)
    rgb = torch.randint(0, 256, (2, 12, 32, 32, 3), generator=g,
                        dtype=torch.uint8)
    dep = torch.rand(2, 12, 64, 64, 1, generator=g)
    a, b = ref.perceive(rgb, dep), ctl.perceive(rgb, dep, None)
    assert compare.rel_gap(b["heatmap"], a["heatmap"]) > 1e-2


def test_learn_step_loss_and_rollout_logits(setup):
    """The program's first learn step, dropout on, against the
    reference's replay with the trainer's dropout stream."""
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.training import finetune
    cfg, _, _, table, m = setup
    params, _ = program.agent_params(cfg, 7, DEV)
    env = GeometricNavEnv(2, seed=3, vocab_size=512, max_instr_len=16,
                          image_size=32, depth_size=64)
    tr = finetune.FinetuneTrainer(cfg, env, params=params, device="cpu",
                                  seed=11)
    recs = []
    orig = tr.batch

    def keep(brec):
        recs.append({f.name: getattr(brec, f.name)
                     for f in dataclasses.fields(brec)})
        return orig(brec)

    tr.batch = keep
    tr.train(iters=2)
    want = compare.train_reference(reference, recs, [], table, m, 7, 12,
                                   DEV)
    assert np.allclose(want["loss"], tr.logs["IL_loss"][:2], rtol=1e-5)
    # the reference's replay without dropout gives the rollout's logits
    ref = Ref(weights.make_weights(table, 7, DEV), m)
    with torch.no_grad():
        lg = ref.replay_logits(compare._to_batch(recs[0], DEV), Drop())
    sv = recs[0]["step_valid"]
    rel, _ = compare.logit_gaps(torch.from_numpy(recs[0]["logits"][sv]),
                                lg[torch.from_numpy(sv)])
    assert rel < 1e-5
