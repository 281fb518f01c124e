"""Nothing a run loads is JAX or the JAX package: every navbench module
a run imports, and a tiny serving and training run through the drivers,
in a fresh interpreter; module names compared by their whole top-level
name, so `etpnav_tpu_torch` is allowed."""

import json
import os
import subprocess
import sys

from navbench import common

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROGRAM = r"""
import glob, importlib, importlib.util, json, os, sys, time
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(2)
from navbench import common, compare, harness, model_config, probe, trace
from navbench.drivers import serve_closed, train_il
for path in glob.glob(os.path.join(ROOT, "navbench", "metrics", "*.py")):
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from etpnav_tpu_torch.config import tiny_config
cfg = tiny_config()
spec = {"name": "tiny", "function": "tiny_config", "overrides": {},
        "model": model_config.model_block(cfg),
        "assumed": {"instruction_tokens": {"lengths": [5, 9, 16],
                    "cls_id": 2, "sep_id": 3, "first_word_id": 10},
                    "path_m": {"lengths": [2.0, 3.5, 5.0], "hops": [2, 3]}}}
for drv, name in ((serve_closed, "serve.c8"), (train_il, "train.il")):
    tr = json.load(open(os.path.join(ROOT, "navbench", "traffic",
                                     name + ".json")))
    tr["params"].update(clients=2, envs=2, episodes=16, warm_buckets=[
        [cfg.il.max_traj_len, cfg.planner.max_gmap_len]])
    ctx = common.Context(root=ROOT, cell={"name": "t", "chips": 1},
                         config=spec, traffic=tr, limits={}, seed=2**33,
                         seconds=1.0, trace=False,
                         t_start=time.perf_counter(), device="cpu")
    drv.run(ctx)
print("FORBIDDEN", json.dumps(common.forbidden_modules()))
"""


def test_forbidden_names_are_whole_top_level_names():
    assert "etpnav_tpu_torch" not in common.FORBIDDEN
    assert set(common.FORBIDDEN) == {"jax", "jaxlib", "flax", "etpnav_tpu"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + PROGRAM],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("FORBIDDEN")]
    assert json.loads(line[-1].split(" ", 1)[1]) == []
