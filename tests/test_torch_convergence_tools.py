"""The port's convergence-run tools (`tools/learning_demo.py`,
`tools/record_convergence.py`, `tools/warm_vs_cold.py`), on the CPU at
`tiny_config()`.

- the five cases of tests/test_convergence_tools.py on the port's tools:
  pruning of `ckpt_iter{N}.pt` files (a temporary file of an unfinished
  save left alone), keep = 2, the curve parser, the summary, and the CLI
  with --out;
- a 2-iteration demo interrupted by SIGTERM after iteration 1 (it saves
  and exits), then resumed: `resumed_at` 1, the train envs reseeded by
  the resume iteration, one checkpoint left;
- `warm_vs_cold --tiny --device cpu` at a few steps: both arms' lines
  and the summary;
- the demo's iter-0 held-out eval equal to JAX `FinetuneTrainer.evaluate`
  on the seed + 1000 pool with the same converted weights: within 1e-4
  (tests/test_torch_training.py's evaluate test) plus the 5e-4 of the
  demo's rounding to 3 decimals.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.env.geometric import GeometricNavEnv as JaxGeometricNavEnv
from etpnav_tpu.training import finetune as jft
from etpnav_tpu_torch.models.convert import agent_params_from_jax
from etpnav_tpu_torch.tools import learning_demo, record_convergence, \
    warm_vs_cold
from etpnav_tpu_torch.training.finetune import FinetuneTrainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--config", "tiny", "--num-envs", "2",
        "--eval-episodes", "2"]


def test_prune_checkpoints_keeps_newest(tmp_path):
    for it in (50, 100, 150):
        (tmp_path / f"ckpt_iter{it}.pt").write_bytes(b"x")
    # the temporary file of an unfinished save is never pruned or counted
    (tmp_path / "ckpt_iter200.pt.tmp-123").write_bytes(b"x")
    (tmp_path / "unrelated").write_bytes(b"x")
    learning_demo.prune_checkpoints(str(tmp_path), keep=1)
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_iter150.pt", "ckpt_iter200.pt.tmp-123", "unrelated"]


def test_prune_checkpoints_keep2(tmp_path):
    for it in (10, 20, 30):
        (tmp_path / f"ckpt_iter{it}.pt").write_bytes(b"x")
    learning_demo.prune_checkpoints(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_iter20.pt",
                                            "ckpt_iter30.pt"]


def _demo_log(tmp_path):
    lines = [
        "WARNING: a line that is not JSON",
        json.dumps({"iter": 0, "success": 0.0, "spl": 0.0}),
        json.dumps({"resumed_at": 50}),
        "not json {",
        json.dumps({"iter": 50, "IL_loss": 2.1, "sec_per_iter": 28.0,
                    "success": 0.05, "spl": 0.02}),
        json.dumps({"iter": 100, "IL_loss": 1.4, "sec_per_iter": 27.0,
                    "success": 0.30, "spl": 0.21}),
        json.dumps({"iter": 150, "IL_loss": 1.2, "sec_per_iter": 27.5,
                    "success": 0.25, "spl": 0.18}),
        json.dumps({"interrupted_at": 170}),
    ]
    p = tmp_path / "run.log"
    p.write_text("\n".join(lines) + "\n")
    return p


def test_parse_curve_filters_non_eval_lines(tmp_path):
    curve = record_convergence.parse_curve(str(_demo_log(tmp_path)))
    assert [d["iter"] for d in curve] == [0, 50, 100, 150]


def test_summarize_best_and_final(tmp_path):
    s = record_convergence.summarize(
        record_convergence.parse_curve(str(_demo_log(tmp_path))),
        note="unit")
    assert s["iters"] == 150
    assert s["sr_final"] == 0.25 and s["spl_final"] == 0.18
    assert s["sr_best"] == 0.30 and s["best_iter"] == 100
    assert s["il_loss_final"] == 1.2
    assert s["sr_curve"] == {"0": 0.0, "50": 0.05, "100": 0.30,
                             "150": 0.25}
    assert s["note"] == "unit"


def test_record_convergence_cli(tmp_path):
    out = tmp_path / "CONV.json"
    r = subprocess.run(
        [sys.executable, "-m", "etpnav_tpu_torch.tools.record_convergence",
         str(_demo_log(tmp_path)), "--note", "cli-test", "--out", str(out)],
        capture_output=True, text=True, check=True, cwd=REPO)
    doc = json.loads(out.read_text())
    assert len(doc["curve"]) == 4
    assert doc["summary"]["sr_best"] == 0.30
    assert doc["summary"]["note"] == "cli-test"
    assert json.loads(r.stdout.strip().splitlines()[-1])["iters"] == 150
    # the default record is the port's own, never the JAX package's
    assert record_convergence.DEFAULT_OUT == os.path.join(
        REPO, "etpnav_tpu_torch", "CONVERGENCE.json")


def test_demo_interrupted_and_resumed(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "conv")
    argv = TINY + ["--iters", "2", "--eval-every", "1", "--ckpt-dir", ckpt,
                   "--save-every", "0"]
    train = FinetuneTrainer.train

    def train_then_term(self, *a, **kw):
        logs = train(self, *a, **kw)
        os.kill(os.getpid(), signal.SIGTERM)     # as `timeout` would
        return logs
    monkeypatch.setattr(FinetuneTrainer, "train", train_then_term)
    handler = signal.getsignal(signal.SIGTERM)
    first = learning_demo.main(argv, emit=lambda s: None)
    assert signal.getsignal(signal.SIGTERM) == handler
    assert first[0]["iter"] == 0 and "success" in first[0]
    assert {"interrupted_at": 1} in first
    assert first[-1]["saved"].endswith("ckpt_iter1.pt")
    assert os.listdir(ckpt) == ["ckpt_iter1.pt"]

    monkeypatch.setattr(FinetuneTrainer, "train", train)
    seeds = []
    make_envs = learning_demo.make_envs

    def spy(cfg, n, seed):
        seeds.append(seed)
        return make_envs(cfg, n, seed)
    monkeypatch.setattr(learning_demo, "make_envs", spy)
    second = learning_demo.main(argv, emit=lambda s: None)
    assert second[0] == {"resumed_at": 1}
    # the first pool, the reseeded train pool, then the held-out pool
    assert seeds == [0, 1, 1000]
    evals = [d for d in second if "success" in d]
    assert [d["iter"] for d in evals] == [2]
    assert np.isfinite(evals[0]["IL_loss"])
    assert {"sec_per_iter", "rollout_s", "learn_s", "eval_s", "sr_sem",
            "buckets"} <= set(evals[0])
    assert os.listdir(ckpt) == ["ckpt_iter2.pt"]


def test_warm_vs_cold_tiny(tmp_path):
    lines = []
    last = warm_vs_cold.main(
        ["--tiny", "--device", "cpu", "--pretrain-steps", "2", "--iters",
         "1", "--eval-every", "1", "--eval-episodes", "2", "--num-envs",
         "2", "--batch", "4"], emit=lines.append)
    objs = [json.loads(s) for s in lines]
    assert objs[0]["pretrain_steps"] == 2 and "sap_acc" in objs[0]
    assert [(d["arm"], d["iter"]) for d in objs[1:-1]] == [("cold", 1),
                                                          ("warm", 1)]
    assert objs[-1] == last and set(last["summary"]) == {
        "cold", "warm", "delta_IL_loss"}
    for arm in ("cold", "warm"):
        assert np.isfinite(last["summary"][arm]["IL_loss"])


def test_demo_first_eval_matches_jax():
    jcfg = jax_tiny_config()
    jtr = jft.FinetuneTrainer(
        jcfg, JaxGeometricNavEnv(
            2, seed=1000, vocab_size=jcfg.planner.vocab_size,
            max_instr_len=jcfg.il.max_text_len,
            image_size=jcfg.clip.image_size,
            depth_size=jcfg.depth.input_size,
            pad_id=jcfg.planner.pad_token_id), seed=0)
    want = jtr.evaluate(2)
    agent = agent_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params),
        learning_demo.demo_config("tiny"), device="cpu")
    got = learning_demo.main(TINY + ["--iters", "0"], params=agent.params,
                             emit=lambda s: None)
    assert len(got) == 1 and got[0]["iter"] == 0
    assert got[0]["n_episodes"] == 2
    for key in want:
        np.testing.assert_allclose(got[0][key], want[key],
                                   atol=1e-4 + 5e-4, err_msg=key)


def test_two_training_iterations_match_jax(monkeypatch):
    """Two whole trainer iterations (rollout, bucketed replay, AdamW) of
    both packages from the same weights on the same env pool, every
    dropout off and teacher forcing: the losses within 1e-5 (relative) and
    every planner parameter within 1e-5 after each. The rollouts part at
    the third iteration of env seed 0, at a host-side graph tie (ROADMAP
    §3's recorded differences), so two is what one seed can show."""
    import dataclasses

    from etpnav_tpu.models import bert_core as jbert
    from etpnav_tpu.models import planner as jplanner
    from etpnav_tpu.ops import attention as jattention
    from etpnav_tpu_torch.models import bert_core, planner
    from etpnav_tpu_torch.models.convert import load_jax_tree
    from etpnav_tpu_torch.models.planner import PlannerParams
    from etpnav_tpu_torch.ops import attention
    from etpnav_tpu_torch.training import finetune

    for mod in (jft, jplanner, jbert, jattention):
        if hasattr(mod, "maybe_dropout"):
            monkeypatch.setattr(mod, "maybe_dropout", lambda x, *a, **k: x)
    for mod in (finetune, planner, bert_core, attention):
        if hasattr(mod, "dropout"):
            monkeypatch.setattr(mod, "dropout", lambda x, *a, **k: x)

    def off(cfg):
        return dataclasses.replace(
            cfg, il=dataclasses.replace(cfg.il, waypoint_aug=False,
                                        sample_ratio=1.0),
            planner=dataclasses.replace(cfg.planner, hidden_dropout=0.0,
                                        attn_dropout=0.0))
    jcfg, cfg = off(jax_tiny_config()), off(learning_demo.demo_config("tiny"))
    jtr = jft.FinetuneTrainer(jcfg, JaxGeometricNavEnv(
        2, seed=0, vocab_size=jcfg.planner.vocab_size,
        max_instr_len=jcfg.il.max_text_len, image_size=jcfg.clip.image_size,
        depth_size=jcfg.depth.input_size, pad_id=jcfg.planner.pad_token_id),
        seed=0)
    agent = agent_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params), cfg, device="cpu")
    tr = FinetuneTrainer(cfg, learning_demo.make_envs(cfg, 2, 0),
                         params=agent.params, seed=0, device="cpu")
    for _ in range(2):
        want, got = jtr.train(1)["IL_loss"], tr.train(1)["IL_loss"]
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
        ref = PlannerParams(cfg.planner)
        load_jax_tree(ref, jax.tree_util.tree_map(np.asarray,
                                                  jtr.params.planner))
        ref = dict(ref.named_parameters())
        for n, p in tr.params.planner.named_parameters():
            err = (p.detach() - ref[n].detach()).abs().max().item()
            assert err <= 1e-5, (n, err)
