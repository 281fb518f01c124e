"""The rxr-dsv2lite configuration and its cells: the files resolve and
name their own reference and count modules, the new readers give known
values on synthetic records (and nothing where the program lacks the
counters or spans), and a CPU serving run of a tiny DeepSeek-V2 configuration is
correct under the cell's limits, and incorrect when the program holds a
share that differs from the reference's by one expert."""

import json
import os
import time

import pytest
import torch

from navbench import common, harness, model_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("rxr.serve.c8", "rxr-dsv2lite.serve.c8")


def _spec(name: str) -> dict:
    with open(os.path.join(ROOT, "navbench", "configs", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_cells_resolve(cell):
    from navbench.reference import dsv2lite, model
    from navbench.work import dsv2lite as work_dsv2
    _, c, config, traffic, limits = harness.resolve(ROOT, cell)
    assert c["chips"] == 1 and traffic["driver"] == "serve_closed"
    assert set(limits) == {"txt_rel", "heatmap_rel", "pano_rel",
                           "action_gap", "nms_mismatch", "nav_rel"}
    ref, work = common.modules(config)
    if cell == "rxr.serve.c8":
        assert (ref, config["name"]) == (model, "rxr")
    else:
        assert (ref, work) == (dsv2lite, work_dsv2)


def test_the_configuration_states_its_cut():
    """The file holds the published config.json's numbers at its top
    level, equal to the program's section where both name one; the cut
    (the held experts) is the one `reduced` group, stated beside the
    published count; the program's config equals the `model` block."""
    from navbench import program
    spec = _spec("rxr-dsv2lite.json")
    cfg = program.load_config(spec)
    assert spec["model"] == model_config.model_block(cfg, spec["model"])
    t = spec["model"]["text_llm"]
    pairs = {"hidden_size": "hidden_size", "num_hidden_layers": "num_layers",
             "num_attention_heads": "num_heads",
             "kv_lora_rank": "kv_lora_rank",
             "qk_nope_head_dim": "qk_nope_head_dim",
             "qk_rope_head_dim": "qk_rope_head_dim",
             "v_head_dim": "v_head_dim",
             "intermediate_size": "intermediate_size",
             "moe_intermediate_size": "moe_intermediate_size",
             "n_routed_experts": "n_routed_experts",
             "n_shared_experts": "n_shared_experts",
             "num_experts_per_tok": "num_experts_per_tok",
             "first_k_dense_replace": "first_k_dense_replace",
             "routed_scaling_factor": "routed_scaling_factor",
             "rms_norm_eps": "rms_norm_eps", "rope_theta": "rope_theta",
             "vocab_size": "vocab_size"}
    for top, key in pairs.items():
        assert spec[top] == t[key], top
    rs = spec["rope_scaling"]
    assert (rs["factor"], rs["original_max_position_embeddings"],
            rs["beta_fast"], rs["beta_slow"], rs["mscale"],
            rs["mscale_all_dim"]) == (
        t["rope_factor"], t["rope_original_max_position"],
        t["rope_beta_fast"], t["rope_beta_slow"], t["rope_mscale"],
        t["rope_mscale_all_dim"])
    assert spec["q_lora_rank"] is None and spec["norm_topk_prob"] is False
    assert spec["reduced"] == ["text_llm"]
    ep = spec["expert_parallel"]
    assert (ep["held_here"], ep["n_routed_experts_published"]) == (16, 64)
    assert t["held_experts"] == ep["held_experts"] == list(range(16))
    assert spec["model"]["planner"]["vocab_size"] == t["vocab_size"]
    it = spec["assumed"]["instruction_tokens"]
    assert it["cls_id"] < t["vocab_size"] and it["sep_id"] < t["vocab_size"]
    assert it["first_word_id"] > spec["model"]["planner"]["pad_token_id"]


def _read(name: str, record: dict):
    return harness.read_metric(ROOT, name, record)


def _record(stats1: dict, spans=()) -> dict:
    s0 = {"moe_rows": 100, "moe_groups": 10, "text_encodes": 2}
    s1 = {k: s0[k] + v for k, v in stats1.items()}
    return {"t0": 100.0, "t_end": 151.0, "window_s": 51.0,
            "stats": (s0, s1), "spans": {"encode_text": list(spans)}}


def test_readers_on_synthetic_records():
    spans = [(99.0, 101.0), (110.0, 110.06), (120.0, 120.04),
             (105.2, 105.3), (105.6, 105.7), (106.9, 107.2)]
    rec = _record({"moe_rows": 5200, "moe_groups": 400,
                   "text_encodes": 20}, spans)
    # spans that started in the window: all but the first
    assert _read("encode_ms.serve", rec) == pytest.approx(
        (60 + 40 + 100 + 100 + 300) / 5)
    assert _read("expert_rows.serve", rec) == pytest.approx(5200 / 400)
    # a program without the counters
    parent = dict(rec, stats=({"text_encodes": 1}, {"text_encodes": 3}))
    assert _read("expert_rows.serve", parent) is None
    assert _read("encode_ms.serve", dict(rec, spans={})) is None


def tiny_spec(**keys) -> dict:
    from etpnav_tpu_torch.config import tiny_dsv2_config
    return {"name": "tiny-dsv2", "function": "tiny_dsv2_config",
            "overrides": {}, "reduced": ["text_llm"],
            "reference": "navbench.reference.dsv2lite",
            "work": "navbench.work.dsv2lite",
            "model": model_config.model_block(
                tiny_dsv2_config(), model_config.ETPNAV + ("text_llm",)),
            "assumed": {"instruction_tokens": {
                "lengths": [5, 9, 16], "cls_id": 2, "sep_id": 3,
                "first_word_id": 10}},
            **keys}


def _serve(cell: str = "rxr-dsv2lite.serve.c8") -> tuple:
    """(correct, the output of `serve_closed.run`) of a short CPU
    serving run of the tiny configuration under the cell's limits."""
    from navbench.drivers import serve_closed
    with open(os.path.join(ROOT, "navbench", "traffic",
                           "serve.c8.json")) as f:
        tr = json.load(f)
    tr["params"].update(clients=3, trace_seconds=0.2)
    with open(os.path.join(ROOT, "navbench", "limits", cell + ".json")) as f:
        limits = json.load(f)["numbers"]
    torch.set_num_threads(2)
    ctx = common.Context(root=ROOT, cell={"name": cell, "chips": 1},
                         config=tiny_spec(), traffic=tr, limits=limits,
                         seed=2 ** 33 + 7, seconds=1.5, trace=False,
                         t_start=time.perf_counter(), device="cpu")
    out = serve_closed.run(ctx)
    checks = common.judge(out["readings"], limits)
    return bool(checks) and all(c["ok"] for c in checks), out


def test_tiny_serve_run_is_correct():
    ok, out = _serve()
    assert ok, out["readings"]
    assert out["info"]["sessions"] > 0
    assert out["readings"]["txt_rel"] < 1e-4


def test_one_expert_off_the_share_is_incorrect(monkeypatch):
    """The program computes its layer for held experts 1, 3, 4, 7 (its
    weights at 6's place) where the configuration and the reference hold
    1, 3, 4, 6."""
    from etpnav_tpu_torch.models import dsv2_text
    orig = dsv2_text._constants

    def shifted(c, L, device):
        k = dict(orig(c, L, device))
        lut = torch.full_like(k["lut"], len(c.held))
        held = [7 if e == 6 else e for e in c.held]
        lut[held] = torch.arange(len(held), device=lut.device)
        k["lut"] = lut
        return k

    monkeypatch.setattr(dsv2_text, "_constants", shifted)
    ok, out = _serve()
    assert not ok
    assert out["readings"]["txt_rel"] > 1e-2
