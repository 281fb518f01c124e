"""The port's entry points against the JAX package's, on the CPU at
`tiny_config()`: the YAML config, the runner (`run` with `--device cpu`:
train / eval / inference / the checkpoint-folder eval loop, the
pretrained-planner branch, the refusals), `convert_cli` on raw files in
the released wrappings, the episode loaders, the tokenizer and the
logging utilities.

Exact comparisons throughout (config values, parsed options, episode
fields, token ids, state-dict tensors with `torch.equal`); the runner's
train / eval / inference outputs are checked for what they must contain,
since the port's training draws differ from JAX's (ROADMAP §3).
"""

import dataclasses
import gzip
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

from etpnav_tpu import config as jconfig
from etpnav_tpu import config_yaml as jyaml
from etpnav_tpu import convert_cli as jcli
from etpnav_tpu.data import episodes as jep
from etpnav_tpu.data import tokenization as jtok
from etpnav_tpu.models import convert as jconvert
from etpnav_tpu.utils import logging as jlog
from etpnav_tpu_torch import config as C
from etpnav_tpu_torch import config_yaml, convert_cli
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.data import episodes, tokenization
from etpnav_tpu_torch.models import clip_vit, depth_resnet, planner, waypoint
from etpnav_tpu_torch.models.convert import load_jax_tree
from etpnav_tpu_torch.run import run, run_config
from etpnav_tpu_torch.training.checkpoints import load_checkpoint
from etpnav_tpu_torch.utils import logging as tlog
from test_encoders import _TorchDepthEncoder, _torch_to_ref_state_dict
from test_released_layout_roundtrip import TorchNavCMT, TorchTRM
from test_torch_convert import openai_clip_state_dict, seed_params

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_YAML = str(ROOT / "configs" / "r2r_tiny.yaml")


# ---------------------------------------------------------------------------
# YAML config
# ---------------------------------------------------------------------------

# the port's form of a JAX module switch (clip_vit.USE_FUSED_BLOCK), and
# the torch.distributed backend, which JAX does not choose
PORT_ONLY = {("clip", "use_fused_block"), ("mesh", "backend")}
# fields whose default the port sets apart (ROADMAP §3): IL.remat_nav is
# off, where the JAX package turns it on for a v5e's memory
PORT_DEFAULTS = {("il", "remat_nav")}
# sections the JAX package has no counterpart of: the DeepSeek-V2
# instruction encoder (off in every configuration both packages load)
PORT_ONLY_SECTIONS = {"text_llm"}


def assert_config_matches_jax(ours, theirs):
    """Every field of the port's config (section by section) has the JAX
    config's value."""
    for f in dataclasses.fields(ours):
        if f.name in PORT_ONLY_SECTIONS:
            assert not getattr(ours, f.name).enabled, f.name
            continue
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            for g in dataclasses.fields(a):
                if (f.name, g.name) in PORT_ONLY:
                    continue
                if (f.name, g.name) in PORT_DEFAULTS:
                    assert getattr(a, g.name) == getattr(type(a)(), g.name) \
                        or getattr(a, g.name) == getattr(b, g.name), \
                        (f.name, g.name)
                    continue
                assert getattr(a, g.name) == getattr(b, g.name), \
                    (f.name, g.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", ["r2r.yaml", "rxr.yaml", "r2r_tiny.yaml",
                                  "pretrain.yaml", "dagger_r2r.yaml"])
def test_yaml_configs_load_to_jax_values(name):
    path = str(ROOT / "configs" / name)
    opts = ["IL.lr=3.0e-5", "CLIP.use_fused_block=true",
            "EVAL.split=val_seen", "PLANNER.nav_use_bf16=false",
            "IL.agg_dense_device=true", "IL.depth_transport_uint16=true",
            "IL.remat=true", "IL.remat_nav=true", "IL.remat_nav_min_gmap=64",
            "RESTART_CRASHED_WORKERS=true", "SHM_OBSERVATIONS=true"]
    ours = config_yaml.load_config(path, config_yaml.parse_cli_opts(opts))
    theirs = jyaml.load_config(path, jyaml.parse_cli_opts(
        [o for o in opts if not o.startswith("CLIP.") and "." in o]))
    theirs = dataclasses.replace(theirs, restart_crashed_workers=True,
                                 shm_observations=True)
    assert ours.clip.use_fused_block is True
    assert (ours.il.remat_nav, ours.il.remat_nav_min_gmap) == (True, 64)
    assert ours.restart_crashed_workers and ours.shm_observations
    assert_config_matches_jax(ours, theirs)


@pytest.mark.parametrize("section,item", [("MESH", "Distribution")])
def test_unported_sections_raise(tmp_path, section, item):
    """Every section of the JAX package's config is ported: MESH (the
    last one, ROADMAP §1 "Distribution") loads to the JAX values plus
    the port's backend, and a section neither package has raises."""
    path = tmp_path / "exp.yaml"
    path.write_text(f"BASE: r2r\n{section}:\n  mp: 2\n  dp: 2\n")
    ours = config_yaml.load_config(str(path))
    theirs = jyaml.load_config(str(path))
    assert (ours.mesh.dp, ours.mesh.mp, ours.mesh.backend) == (2, 2, "")
    assert_config_matches_jax(ours, theirs)
    path.write_text(f"BASE: r2r\n{section}:\n  backend: gloo\n")
    assert config_yaml.load_config(str(path)).mesh.backend == "gloo"
    path.write_text(f"BASE: r2r\n{item.upper()}:\n  mp: 2\n")
    with pytest.raises(KeyError, match=f"unknown config section "
                                       f"'{item.upper()}'"):
        config_yaml.load_config(str(path))


def test_dagger_yaml_loads_to_jax_values():
    """configs/dagger_r2r.yaml (the DAGGER section, ported) loads to the
    JAX package's values, with DAGGER overrides from the command line."""
    path = str(ROOT / "configs" / "dagger_r2r.yaml")
    opts = ["DAGGER.policy=cma", "DAGGER.iterations=2",
            "DAGGER.la_layers=3", "DAGGER.policy_ckpt=pytorch_model.bin"]
    ours = config_yaml.load_config(path, config_yaml.parse_cli_opts(opts))
    theirs = jyaml.load_config(path, jyaml.parse_cli_opts(opts))
    assert (ours.dagger.policy, ours.dagger.iterations,
            ours.dagger.la_layers) == ("cma", 2, 3)
    assert ours.dagger.episodes_per_iter == 128
    assert_config_matches_jax(ours, theirs)
    assert_config_matches_jax(C.tiny_config(), jconfig.tiny_config())


def test_unknown_and_jax_only_keys_raise():
    assert config_yaml.config_from_dict(
        {"BASE": "tiny", "MESH": {"mp": 2}}).mesh.mp == 2
    with pytest.raises(KeyError, match="unknown config keys.*devices"):
        config_yaml.config_from_dict({"MESH": {"devices": 8}})
    # a JAX-only switch the port does not read is refused, not dropped,
    # and the message says it is TPU-only
    with pytest.raises(KeyError, match="attn_probs_bf16"):
        config_yaml.config_from_dict({"IL": {"attn_probs_bf16": True}})
    for section in ("PLANNER", "IL"):
        with pytest.raises(KeyError, match="remat_policy.*TPU program"):
            config_yaml.config_from_dict(
                {section: {"remat_policy": "dots_saveable"}})
    # the env-worker keys and the IL switches are ported (ROADMAP §1
    # items 2 and 5): they load to the JAX package's values
    keys = {"BASE": "tiny", "SHM_OBSERVATIONS": True,
            "RESTART_CRASHED_WORKERS": True,
            "IL": {"agg_dense_device": True, "depth_transport_uint16": True,
                   "remat": True, "remat_nav": True,
                   "remat_nav_min_gmap": 16},
            "PLANNER": {"remat_scan": True}}
    assert_config_matches_jax(config_yaml.config_from_dict(keys),
                              jyaml.config_from_dict(keys))
    with pytest.raises(KeyError, match="NOPE"):
        config_yaml.config_from_dict({"NOPE": {}})
    with pytest.raises(KeyError, match="BASE"):
        config_yaml.config_from_dict({"BASE": "vit"})
    cfg = config_yaml.config_from_dict({
        "BASE": "tiny", "PRETRAINED_PATH": "/x/model_step_82500.pt",
        "NUM_ENVIRONMENTS": 4, "PATHS": {"roles": ["guide", "follower"]},
        "INFERENCE": {"sample": True, "format": "rxr"}})
    jcfg = jyaml.config_from_dict({
        "BASE": "tiny", "PRETRAINED_PATH": "/x/model_step_82500.pt",
        "NUM_ENVIRONMENTS": 4, "PATHS": {"roles": ["guide", "follower"]},
        "INFERENCE": {"sample": True, "format": "rxr"}})
    assert cfg.paths.roles == ("guide", "follower")
    assert_config_matches_jax(cfg, jcfg)


def test_top_level_opts_override():
    """'KEY=value' sets a top-level key (the JAX loader nests it under an
    empty key; the port sets it)."""
    cfg = config_yaml.load_config(TINY_YAML, config_yaml.parse_cli_opts(
        ["PRETRAINED_PATH=model_step_82500.pt", "SEED=3", "IL.iters=4"]))
    assert cfg.pretrained_path == "model_step_82500.pt"
    assert (cfg.seed, cfg.il.iters) == (3, 4)


def test_parse_cli_opts_matches_jax():
    pairs = ["IL.lr=1e-5", "IL.iters=7", "CLIP.use_fused_block=true",
             "PLANNER.gmap_len_buckets=[16, 32]", "EVAL.split=val_seen",
             "PATHS.data_path=", "SEED=3", "IL.ghost_aug=0.25"]
    assert config_yaml.parse_cli_opts(pairs) == jyaml.parse_cli_opts(pairs)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _exp(tmp_path, extra=""):
    p = tmp_path / "exp.yaml"
    p.write_text("BASE: tiny\nIL: {iters: 2, log_every: 1}\n"
                 f"RESULTS_DIR: {tmp_path / 'results'}\n" + extra)
    return str(p)


def test_run_train_eval_inference_and_eval_loop(tmp_path):
    exp = _exp(tmp_path)
    ck = tmp_path / "ck"
    base = ["--exp-config", exp, "--device", "cpu", "--ckpt-dir", str(ck),
            "--num-envs", "2"]
    logs = run(base + ["--run-type", "train"])
    assert np.isfinite(logs["IL_loss"])
    assert sorted(os.listdir(ck)) == ["ckpt_iter1.pt", "ckpt_iter2.pt"]
    state = load_checkpoint(str(ck / "ckpt_iter2.pt"))
    assert state["iteration"] == 2

    stats = run(base + ["--run-type", "eval", "--episode-count", "2",
                        "--ckpt", str(ck / "ckpt_iter2.pt")])
    assert stats["n_episodes"] >= 2 and 0.0 <= stats["success"] <= 1.0

    preds = tmp_path / "preds.json"
    paths = run(base + ["--run-type", "inference", "--episode-count", "2",
                        "--predictions-file", str(preds)])
    written = json.loads(preds.read_text())
    assert set(written) == set(paths) and len(written) >= 2
    assert all("position" in p for v in written.values() for p in v)

    preds_rxr = tmp_path / "preds.jsonl"
    run(base + ["--run-type", "inference", "--episode-count", "2",
                "--predictions-file", str(preds_rxr),
                "INFERENCE.format=rxr"])
    lines = [json.loads(l) for l in preds_rxr.read_text().splitlines()]
    assert len(lines) >= 2
    assert [l["instruction_id"] for l in lines] == sorted(
        l["instruction_id"] for l in lines)
    assert all(len(p) == 3 for l in lines for p in l["path"])

    loop = run(base + ["--run-type", "eval", "--episode-count", "2",
                       f"EVAL.ckpt_path_dir={ck}"])
    assert sorted(loop) == [str(ck / "ckpt_iter1.pt"),
                            str(ck / "ckpt_iter2.pt")]
    assert sorted(os.listdir(tmp_path / "results")) == [
        "stats_ckpt_1_val_unseen.json", "stats_ckpt_2_val_unseen.json"]


def test_run_trainer_dagger(tmp_path):
    """`--trainer DAgger` runs (the JAX runner's registry entry): one
    DAgger iteration of the recurrent VLN-BERT at tiny size, then the
    greedy eval of the same configuration."""
    base = ["--exp-config", _exp(tmp_path), "--device", "cpu",
            "--num-envs", "2", "--trainer", "DAgger",
            f"DAGGER.store_dir={tmp_path / 'store'}"]
    losses = run(base)
    assert len(losses) == 1 and np.isfinite(losses).all()
    stats = run(base + ["--run-type", "eval", "--episode-count", "2"])
    assert np.isfinite(stats["spl"])


def test_run_refusals(tmp_path, monkeypatch):
    exp = _exp(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(["--exp-config", exp, "--num-envs", "2"])
    base = ["--exp-config", exp, "--device", "cpu", "--num-envs", "2"]
    # a mesh needs a launched world (torchrun): one process is refused
    with pytest.raises(ValueError, match=r"world size \(1\)"):
        run(base + ["MESH.dp=2"])
    with pytest.raises(ValueError, match="one process"):
        run(base + ["--trainer", "DAgger", "MESH.mp=2"])
    # a directory is a JAX (orbax) pretrain checkpoint: not read
    with pytest.raises(NotImplementedError, match="orbax"):
        run(["--exp-config", _exp(tmp_path, f"PRETRAINED_PATH: {tmp_path}\n"),
             "--device", "cpu", "--num-envs", "2"])
    with pytest.raises(TypeError, match="bogus"):
        run_config(tiny_config(), bogus=1)
    with pytest.raises(SystemExit):
        run(["--device", "cpu"])                  # no --exp-config


def test_run_with_workers_and_pipeline_halves(tmp_path):
    """`--workers --pipeline-halves 2` with the worker keys and the IL
    switches on: 4 envs in 2 pools of 2 forkserver workers train one
    iteration; the runner stops every worker when it returns."""
    import multiprocessing

    exp = _exp(tmp_path, "RESTART_CRASHED_WORKERS: true\n"
                         "SHM_OBSERVATIONS: true\n")
    ck = tmp_path / "ck"
    logs = run(["--exp-config", exp, "--device", "cpu", "--num-envs", "4",
                "--workers", "--pipeline-halves", "2", "--ckpt-dir", str(ck),
                "IL.iters=1", "IL.agg_dense_device=true",
                "IL.depth_transport_uint16=true", "IL.remat=true",
                "IL.remat_nav=true", "IL.remat_nav_min_gmap=0"])
    assert np.isfinite(logs["IL_loss"])
    assert sorted(os.listdir(ck)) == ["ckpt_iter1.pt"]
    assert multiprocessing.active_children() == []
    with pytest.raises(ValueError, match="does not divide"):
        run(["--exp-config", exp, "--device", "cpu", "--num-envs", "3",
             "--pipeline-halves", "2"])


def _tiny_pretrain_file(tmp_path):
    cfg = tiny_config().planner
    model = seed_params(TorchNavCMT(cfg).eval(), 21)
    sd = {("" if k.startswith("global_sap_head.") else "bert.") + k: v
          for k, v in model.state_dict().items()}
    path = tmp_path / "model_step_82500.pt"
    torch.save(sd, path)
    return str(path), sd


def test_pretrained_path_loads_the_released_planner(tmp_path, monkeypatch):
    """MODEL.pretrained_path: the runner converts the released pretrain
    file into the planner, as JAX's run.py does (same tree), and the
    optimizer starts fresh; here through serve mode, which returns the
    server."""
    path, sd = _tiny_pretrain_file(tmp_path)
    httpd, nav = run(["--exp-config", _exp(tmp_path,
                                           f"PRETRAINED_PATH: {path}\n"),
                      "--device", "cpu", "--run-type", "serve",
                      "--serve-nonblocking", "--host", "127.0.0.1",
                      "--port", "0"])
    try:
        got = nav.agent.params.planner
        p = tiny_config().planner
        want = planner.PlannerParams(p)
        load_jax_tree(want, jconvert.convert_planner(
            sd, p.num_l_layers, p.num_pano_layers, p.num_x_layers))
        for (n, a), (_, b) in zip(got.state_dict().items(),
                                  want.state_dict().items()):
            assert torch.equal(a, b), n
    finally:
        httpd.shutdown()
        httpd.server_close()
        nav.shutdown()

    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer
    cfg = tiny_config()
    # the trainer's scalars, through the JSONL fallback
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tr = FinetuneTrainer(cfg, GeometricNavEnv(2, seed=0, vocab_size=512,
                                              max_instr_len=16,
                                              image_size=32, depth_size=64),
                         tb_dir=str(tmp_path / "tb"), device="cpu")
    logs = tr.train(1)
    tr.writer.close()
    rows = [json.loads(l) for l in
            (tmp_path / "tb" / "scalars.jsonl").read_text().splitlines()]
    assert rows == [{"tag": "loss/IL_loss", "value": logs["IL_loss"],
                     "step": 1}]
    assert set(tr.timer.means()) == {"rollout", "learn"}
    assert tr.optimizer.state
    tr.load_pretrained_planner(path)
    assert not tr.optimizer.state            # fresh AdamW
    assert tr.optimizer.param_groups[0]["params"][0] is next(
        tr.params.planner.parameters())


# ---------------------------------------------------------------------------
# convert_cli on raw files in the released wrappings
# ---------------------------------------------------------------------------

class _Holder(nn.Module):
    def forward(self, x):
        return x


def torchscript_archive(sd: dict, path: str) -> None:
    """A TorchScript archive holding `sd` under its dotted names, as
    openai CLIP's released `ViT-B-32.pt` is."""
    root = _Holder()
    for name, t in sd.items():
        *mods, leaf = name.split(".")
        m = root
        for part in mods:
            if not hasattr(m, part):
                m.add_module(part, nn.Module())
            m = getattr(m, part)
        m.register_parameter(leaf, nn.Parameter(t.clone(),
                                                requires_grad=False))
    torch.jit.trace(root, torch.zeros(1)).save(path)


def released_file(kind: str, tmp_path) -> tuple:
    """(path, module class) of a raw released file at tiny widths."""
    cfg = tiny_config()
    path = str(tmp_path / f"{kind}.released")
    if kind == "planner":
        model = seed_params(TorchNavCMT(cfg.planner).eval(), 31)
        torch.save({"module." + ("" if k.startswith("global_sap_head.")
                                 else "bert.") + k: v
                    for k, v in model.state_dict().items()}, path)
        return path, planner.PlannerParams, cfg.planner
    if kind == "waypoint":
        model = seed_params(TorchTRM(cfg.waypoint).eval(), 32)
        torch.save({"predictor": {f"module.{k}": v for k, v in
                                  model.state_dict().items()},
                    "epoch": 7}, path)
        return path, waypoint.WaypointParams, cfg.waypoint
    if kind == "clip":
        torchscript_archive(openai_clip_state_dict(cfg.clip, 33), path)
        return path, clip_vit.ClipParams, cfg.clip
    model = seed_params(_TorchDepthEncoder(cfg.depth).eval(), 34)
    sd = _torch_to_ref_state_dict(model, cfg.depth)
    torch.save({"state_dict": {
        f"actor_critic.net.visual_encoder.{k}": torch.from_numpy(v)
        for k, v in sd.items()}, "extra_state": {"step": 1}}, path)
    return path, depth_resnet.DepthParams, cfg.depth


def _jax_tree(kind, sd, cfg):
    """The JAX converter's tree of `sd`, at the widths of the port's
    config section `cfg`."""
    from etpnav_tpu.config import ClipConfig, DepthEncoderConfig
    from etpnav_tpu.models import clip_vit as jclip
    from etpnav_tpu.models import depth_resnet as jdepth

    def jax_cfg(cls):
        return cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cls)})
    if kind == "planner":
        return jconvert.convert_planner(sd, cfg.num_l_layers,
                                        cfg.num_pano_layers,
                                        cfg.num_x_layers)
    if kind == "waypoint":
        return jconvert.convert_waypoint(sd, cfg.num_layers)
    if kind == "clip":
        return jclip.convert_openai_clip(sd, jax_cfg(ClipConfig))
    return jdepth.convert_ddppo_depth(sd, jax_cfg(DepthEncoderConfig))


@pytest.mark.parametrize("kind", convert_cli.KINDS)
def test_convert_cli_round_trips_each_kind(kind, tmp_path, capsys,
                                           monkeypatch):
    """The port's key surgery returns JAX's state dict key for key; the
    CLI writes the port's checkpoint of the sub-module, whose every
    tensor equals the module loaded from the JAX converter's tree."""
    path, cls, cfg = released_file(kind, tmp_path)
    ours = convert_cli.load_torch_state_dict(path, kind)
    theirs = jcli.load_torch_state_dict(path, kind)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert torch.equal(ours[k], theirs[k]), k
    out = str(tmp_path / f"{kind}.pt")
    # the CLI converts at the preset's widths: r2r's, made tiny here
    monkeypatch.setattr(C, "r2r_config", tiny_config)
    convert_cli.main(["--kind", kind, "--torch-ckpt", path, "--out", out])
    assert f"converted {kind}" in capsys.readouterr().out
    want = cls(cfg)
    load_jax_tree(want, _jax_tree(kind, theirs, cfg))
    got = load_checkpoint(out)
    assert list(got) == list(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    module = cls(cfg)
    module.load_state_dict(got)                 # reads back strictly


def test_torchscript_archive_read_where_torch_load_refuses(tmp_path,
                                                          monkeypatch):
    """A PyTorch whose `torch.load` refuses TorchScript archives: the
    archive is read with `torch.jit.load` and its state dict taken."""
    path, _, _ = released_file("clip", tmp_path)
    want = convert_cli.load_torch_state_dict(path, "clip")

    def refuse(*a, **k):
        raise RuntimeError("TorchScript archives are not supported")
    monkeypatch.setattr(convert_cli.torch, "load", refuse)
    got = convert_cli.load_torch_state_dict(path, "clip")
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# data: episodes and tokenization
# ---------------------------------------------------------------------------

def _episode(i, scene, lang="en-US", iid=None):
    instr = {"instruction_text": f"walk to room {i}",
             "instruction_tokens": list(range(1, 5 + i)), "language": lang}
    if iid is not None:
        instr["instruction_id"] = iid
    return {"episode_id": 100 + i, "scene_id": scene,
            "instruction": instr,
            "start_position": [i, 0.0, -i],
            "start_rotation": [0.0, np.sin(i / 4), 0.0, np.cos(i / 4)],
            "goals": [{"position": [i + 2.0, 0.0, 1.0]}],
            "reference_path": [[i, 0.0, -i], [i + 2.0, 0.0, 1.0]]}


def _write_gz(path, payload):
    with gzip.open(path, "wt") as f:
        json.dump(payload, f)


def _same_episodes(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, list):
                assert len(x) == len(y)
                for p, q in zip(x, y):
                    np.testing.assert_array_equal(p, q)
            elif isinstance(y, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, f.name


def test_episode_loaders_match_jax(tmp_path):
    r2r = tmp_path / "val_unseen.json.gz"
    _write_gz(r2r, {"episodes": [_episode(i, f"s{i % 3}") for i in range(7)]})
    kw = {"max_instr_len": 8, "pad_id": 0}
    _same_episodes(episodes.load_r2r_episodes(str(r2r), **kw),
                   jep.load_r2r_episodes(str(r2r), **kw))
    allowed = ["101", "104"]
    _same_episodes(
        episodes.load_r2r_episodes(str(r2r), episodes_allowed=allowed, **kw),
        jep.load_r2r_episodes(str(r2r), episodes_allowed=allowed, **kw))

    for role in ("guide", "follower"):
        _write_gz(tmp_path / f"val_{role}.json.gz", {"episodes": [
            _episode(i, f"r{i % 2}", lang=("hi-IN" if i % 2 else "en-IN"),
                     iid=(i if i != 3 else "x")) for i in range(5)]})
    rxr = str(tmp_path / "val_{role}.json.gz")
    for roles, langs in ((("*",), ("*",)), (("guide",), ("en",))):
        kw = {"roles": roles, "languages": langs, "max_instr_len": 6}
        ours = episodes.load_rxr_episodes(rxr, **kw)
        _same_episodes(ours, jep.load_rxr_episodes(rxr, **kw))
    with pytest.raises(ValueError, match="roles"):
        episodes.load_rxr_episodes(rxr, roles=("narrator",))

    eps = episodes.load_r2r_episodes(str(r2r))
    jeps = jep.load_r2r_episodes(str(r2r))
    _same_episodes(episodes.fast_eval_subset(eps), jep.fast_eval_subset(jeps))
    assert episodes.scenes_of(eps) == jep.scenes_of(jeps)
    for n in (2, 5):
        ours = episodes.shard_episodes_by_scene(eps, n)
        theirs = jep.shard_episodes_by_scene(jeps, n)
        assert [[e.episode_id for e in s] for s in ours] == \
            [[e.episode_id for e in s] for s in theirs]

    gt = tmp_path / "val_unseen_gt.json.gz"
    _write_gz(gt, {"101": {"locations": [[0, 0, 0], [1, 0, 2.5]]},
                   "102": {"locations": [[3, 0, 1]]}})
    ours, theirs = episodes.load_gt_paths(str(gt)), jep.load_gt_paths(str(gt))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_tokenizers_match_jax(tmp_path, monkeypatch):
    """bert-base-uncased from the vendored vocab, and the XLM-R
    tokenizer.json seam, offline: the same ids as JAX's."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    ours, theirs = tokenization.get_tokenizer("r2r"), jtok.get_tokenizer(
        "r2r")
    for text, n in (("Walk past the sofa and stop at the kitchen counter.",
                     16), ("Turn left, go upstairs; wait by the door.", 8)):
        got = tokenization.encode_instruction(ours, text, n)
        want = jtok.encode_instruction(theirs, text, n)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
    assert tokenization._default_config_dirs()[-1] == \
        jtok._default_config_dirs()[-1]

    from tokenizers import Tokenizer, models, pre_tokenizers
    tok = Tokenizer(models.WordLevel(
        {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "walk": 4,
         "left": 5}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    monkeypatch.setenv("ETPNAV_XLMR_TOKENIZER", str(tmp_path))
    x, y = tokenization.get_tokenizer("rxr"), jtok.get_tokenizer("rxr")
    assert tokenization.encode_instruction(x, "walk left", 5).tolist() == \
        jtok.encode_instruction(y, "walk left", 5).tolist() == [4, 5, 1, 1, 1]


# ---------------------------------------------------------------------------
# logging utilities
# ---------------------------------------------------------------------------

def test_logging_utilities_match_jax(tmp_path, monkeypatch):
    timer, theirs = tlog.StepTimer(window=2), jlog.StepTimer(window=2)
    for _ in range(3):
        for t in (timer, theirs):
            with t.phase("rollout"):
                pass
    assert set(timer.means()) == set(theirs.means()) == {"rollout"}
    assert timer.last("rollout") >= 0.0

    tlog.TensorboardLogger(None).add_scalar("x", 1.0)    # writes nothing
    # without torch.utils.tensorboard the scalars go to JSONL
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = tlog.TensorboardLogger(str(tmp_path / "tb"))
    w.add_scalars({"loss/IL_loss": 1.5, "time/learn": 0.25}, step=3)
    w.close()
    jw = jlog.TensorboardLogger(str(tmp_path / "jtb"))
    jw.add_scalars({"loss/IL_loss": 1.5, "time/learn": 0.25}, step=3)
    jw.close()
    rows = [json.loads(l) for l in
            (tmp_path / "tb" / "scalars.jsonl").read_text().splitlines()]
    assert rows == [{"tag": "loss/IL_loss", "value": 1.5, "step": 3},
                    {"tag": "time/learn", "value": 0.25, "step": 3}]
    assert (tmp_path / "jtb" / "scalars.jsonl").read_text() == \
        (tmp_path / "tb" / "scalars.jsonl").read_text()
