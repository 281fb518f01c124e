"""The port's pretrain -> fine-tune warm start (`training/warm_start.py`,
`FinetuneTrainer.load_pretrained`, the runner's `--trainer Pretrain` and
MODEL.pretrained_path) on the CPU at the tiny config; the port's side of
`tests/test_warm_start.py`.

- The surgery yields exactly the fine-tune planner's tensors (names and
  shapes), and commutes with the weight conversion: JAX's
  `pretrain_to_planner` of a seeded tree, carried across, equals the
  port's surgery of the same tree carried across, bit for bit.
- A `PretrainTrainer` checkpoint handed to `FinetuneTrainer` carries the
  trunk exactly (`torch.equal`) and training goes on.
- A checkpoint of another PlannerConfig, a structure mismatch and a file
  that is not a pretrain checkpoint raise.
- The runner pretrains, saves `model_step_N.pt`, resumes, and a
  fine-tune run with PRETRAINED_PATH at that file starts from its trunk.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.training import pretrain as jpt
from etpnav_tpu.training import warm_start as jws
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.models.convert import load_jax_tree, \
    pretrain_params_from_jax
from etpnav_tpu_torch.models.planner import PlannerParams
from etpnav_tpu_torch.run import run
from etpnav_tpu_torch.training import checkpoints
from etpnav_tpu_torch.training import pretrain as pt
from etpnav_tpu_torch.training import warm_start as ws
from etpnav_tpu_torch.training.finetune import FinetuneTrainer

torch.set_num_threads(2)

TASKS = ("mlm", "sap", "mrc", "og")


def _cfg(tasks=("mlm", "sap")):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, planner=dataclasses.replace(cfg.planner, num_nav_types=3),
        pretrain=dataclasses.replace(cfg.pretrain, batch_size=2,
                                     tasks=tasks,
                                     task_ratios=(1.0,) * len(tasks),
                                     image_prob_size=24, num_objs=2))


def _envs(cfg, n=2):
    return GeometricNavEnv(
        num_envs=n, seed=0, vocab_size=cfg.planner.vocab_size,
        max_instr_len=cfg.il.max_text_len, image_size=cfg.clip.image_size,
        depth_size=cfg.depth.input_size, pad_id=cfg.planner.pad_token_id)


def test_surgery_matches_finetune_structure_and_jax():
    cfg = _cfg(TASKS)
    pre = pt.init_pretrain_params(cfg.planner,
                                  torch.Generator().manual_seed(0), TASKS,
                                  24)
    trunk = ws.pretrain_to_planner(pre.state_dict())
    like = PlannerParams(cfg.planner).state_dict()
    assert set(trunk) == set(like)
    assert all(trunk[k].shape == like[k].shape for k in like)
    assert not any(k.split(".")[0] in ws.PRETRAIN_ONLY_HEADS for k in trunk)
    assert not any(f".{k}." in name for k in ws.LANG2VISN_KEYS
                   for name in trunk)
    # the tensors are the pretrain model's own, not copies or re-inits
    assert trunk["embeddings.word_embeddings"].data_ptr() == \
        pre.embeddings.word_embeddings.data_ptr()

    # JAX's surgery on a seeded tree, carried across, equals the port's
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, planner=dataclasses.replace(
        jcfg.planner, num_nav_types=3))
    tree = jax.tree_util.tree_map(np.asarray, jpt.init_pretrain_params(
        jax.random.PRNGKey(3), jcfg.planner, TASKS, 24))
    want = PlannerParams(cfg.planner)
    load_jax_tree(want, jws.pretrain_to_planner(tree))
    got = ws.pretrain_to_planner(
        pretrain_params_from_jax(tree, cfg).state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def pretrain_ckpt(tmp_path_factory):
    cfg = _cfg()
    tr = pt.PretrainTrainer(cfg, pt.pretrain_shapes(cfg), seed=0,
                            num_scans=2, scan_size=12, device="cpu")
    tr.train_steps(2)
    path = str(tmp_path_factory.mktemp("pre") / "model_step_2.pt")
    tr.save_checkpoint(path)
    return cfg, tr, path


def test_checkpoint_handoff_end_to_end(pretrain_ckpt):
    cfg, pre, path = pretrain_ckpt
    assert ws.is_pretrain_checkpoint(path)
    tr = FinetuneTrainer(cfg, _envs(cfg), seed=1, device="cpu")
    before = tr.params.planner.embeddings.word_embeddings.detach().clone()
    old_opt = tr.optimizer
    tr.load_pretrained(path)
    got = tr.params.planner
    assert torch.equal(got.embeddings.word_embeddings,
                       pre.params.embeddings.word_embeddings)
    assert not torch.equal(got.embeddings.word_embeddings, before)
    # the SAP head transfers too (vlnbert_init.py:27 keeps it)
    assert torch.equal(got.global_sap_head.dense2.weight,
                       pre.params.global_sap_head.dense2.weight)
    for k, v in ws.pretrain_to_planner(pre.params.state_dict()).items():
        assert torch.equal(got.state_dict()[k], v), k
    # a fresh optimizer, and the agent reads the loaded planner
    assert tr.optimizer is not old_opt and not tr.optimizer.state
    assert tr.agent.params.planner is got
    logs = tr.train(1)
    assert np.isfinite(logs["IL_loss"])


def test_dim_mismatch_is_a_hard_error(tmp_path):
    cfg = _cfg()
    small = dataclasses.replace(cfg.planner, hidden_size=32,
                                intermediate_size=64, num_heads=2)
    pre = pt.init_pretrain_params(small, torch.Generator().manual_seed(0))
    path = str(tmp_path / "model_step_1.pt")
    checkpoints.save_checkpoint(path, {pt.CHECKPOINT_MARKER: 1,
                                       "params": pre.state_dict()})
    planner = PlannerParams(cfg.planner)
    before = {k: v.clone() for k, v in planner.state_dict().items()}
    with pytest.raises(ValueError, match="different PlannerConfig"):
        ws.load_pretrained_planner(path, planner)
    # nothing was copied
    assert all(torch.equal(v, before[k])
               for k, v in planner.state_dict().items())
    # a structure mismatch (a layer fewer) raises too
    fewer = dataclasses.replace(cfg.planner, num_x_layers=1)
    pre = pt.init_pretrain_params(fewer, torch.Generator().manual_seed(0))
    checkpoints.save_checkpoint(path, {pt.CHECKPOINT_MARKER: 1,
                                       "params": pre.state_dict()})
    with pytest.raises(ValueError, match="missing"):
        ws.load_pretrained_planner(path, planner)
    # a file without the marker is not a pretrain checkpoint
    checkpoints.save_checkpoint(path, {"params": pre.state_dict()})
    assert not ws.is_pretrain_checkpoint(path)
    with pytest.raises(ValueError, match="not a pretrain checkpoint"):
        ws.load_pretrained_planner(path, planner)


def _yaml(tmp_path, text):
    p = tmp_path / "exp.yaml"
    p.write_text(text)
    return str(p)


def test_runner_pretrains_resumes_and_warm_starts(tmp_path):
    ck = tmp_path / "pre"
    exp = _yaml(tmp_path, "BASE: tiny\n"
                "PRETRAIN: {num_train_steps: 4, valid_steps: 2, "
                "batch_size: 2, resume: true}\n"
                f"CHECKPOINT_FOLDER: {ck}\n")
    base = ["--exp-config", exp, "--device", "cpu", "--trainer", "Pretrain"]
    logs = run(base + ["--run-type", "train"])
    assert any(k.endswith("_loss") for k in logs)
    assert all(np.isfinite(v) for v in logs.values())
    assert sorted(p.name for p in ck.iterdir()) == ["model_step_2.pt",
                                                    "model_step_4.pt"]
    state = checkpoints.load_checkpoint(str(ck / "model_step_4.pt"))
    assert state["step"] == 4 and pt.CHECKPOINT_MARKER in state
    # resume: PRETRAIN.resume picks up step 4 and runs to 6
    logs = run(base + ["--run-type", "train", "PRETRAIN.num_train_steps=6"])
    assert sorted(p.name for p in ck.iterdir()) == [
        "model_step_2.pt", "model_step_4.pt", "model_step_6.pt"]
    with pytest.raises(ValueError, match="--run-type eval"):
        run(base + ["--run-type", "eval"])

    # fine-tune from the pretrain file: the runner's warm start branch
    ft = _yaml(tmp_path, "BASE: tiny\nIL: {iters: 1, log_every: 1}\n"
               f"PRETRAINED_PATH: {ck / 'model_step_6.pt'}\n")
    out = tmp_path / "ft"
    run(["--exp-config", ft, "--device", "cpu", "--num-envs", "2",
         "--ckpt-dir", str(out), "--run-type", "train"])
    pre = checkpoints.load_checkpoint(str(ck / "model_step_6.pt"))
    ft_state = checkpoints.load_checkpoint(str(out / "ckpt_iter1.pt"))
    # the tiny config does not freeze the text encoder, so one IL step
    # moves the table: compare the warm-started planner before training
    tr = FinetuneTrainer(tiny_config(), _envs(tiny_config()), seed=0,
                         device="cpu")
    tr.load_pretrained(str(ck / "model_step_6.pt"))
    assert torch.equal(tr.params.planner.embeddings.word_embeddings,
                       pre["params"]["embeddings.word_embeddings"])
    assert ft_state["iteration"] == 1
    # with the text encoder frozen, the fine-tuned checkpoint's table is
    # the pretrain checkpoint's, exactly
    out2 = tmp_path / "ft2"
    run(["--exp-config", ft, "--device", "cpu", "--num-envs", "2",
         "--ckpt-dir", str(out2), "--run-type", "train",
         "IL.fix_lang_embedding=true"])
    ft_state = checkpoints.load_checkpoint(str(out2 / "ckpt_iter1.pt"))
    assert torch.equal(
        ft_state["params"]["planner.embeddings.word_embeddings"],
        pre["params"]["embeddings.word_embeddings"])


def test_runner_refuses_a_directory_and_an_unknown_file(tmp_path):
    d = tmp_path / "orbax_dir"
    d.mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        run(["--exp-config", _yaml(tmp_path, f"BASE: tiny\n"
                                   f"PRETRAINED_PATH: {d}\n"),
             "--device", "cpu", "--num-envs", "2"])
    junk = tmp_path / "junk.pt"
    torch.save({"weights": torch.zeros(2)}, junk)
    with pytest.raises(ValueError, match="neither a pretrain checkpoint"):
        run(["--exp-config", _yaml(tmp_path, f"BASE: tiny\n"
                                   f"PRETRAINED_PATH: {junk}\n"),
             "--device", "cpu", "--num-envs", "2"])
