"""The port's serving slice as a whole against the JAX package, at
`tiny_config()` on the CPU, plus the port's package rules.

- `perceive` + `score_navigation` of the port's `Agent` (weights carried
  over by `agent_params_from_jax`) against `JittedAgent`: floats at 3e-5
  absolute (fp32 through the CLIP, depth, waypoint and planner stacks in
  another summation order; the module tests hold each part at 2e-5),
  candidate slots identical.
- The port's `NavServer` against the JAX `NavServer` over 2 sessions x 3
  steps with identical observations: identical action sequences.
- No module of the port, and not chip_smoke.py, imports JAX or the JAX
  package; `Agent`/`NavServer` raise without a GPU unless asked for the
  CPU.
"""

import ast
import functools
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.serving import NavServer as JaxNavServer
from etpnav_tpu.training.agent import JittedAgent
from etpnav_tpu.training.agent import init_agent_params as jax_init_agent
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.models.convert import agent_params_from_jax
from etpnav_tpu_torch.serving import NavServer
from etpnav_tpu_torch.training.agent import Agent

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 3e-5


def random_jax_tree(init_fn, *args, seed=0):
    """The tree a JAX `*_init` function returns (structure and shapes from
    `jax.eval_shape`, nothing computed), filled with seeded numpy values:
    norm scales near 1, biases ~0.1, conv kernels He-scaled, every other
    array std 0.02."""
    shapes = jax.eval_shape(lambda k: init_fn(k, *args),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", None)
        z = rng.standard_normal(s.shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name in ("bias", "b"):
            z = 0.1 * z
        elif name == "w" and len(s.shape) == 4:
            z = z * np.sqrt(2.0 / np.prod(s.shape[:3]))
        else:
            z = 0.02 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def agents():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    tree = random_jax_tree(
        lambda k, c: jax_init_agent(k, c), jcfg,
        seed=12)                    # weights whose sessions walk 3 steps
    jparams = type(jax.eval_shape(functools.partial(jax_init_agent,
                                                    cfg=jcfg),
                                  jax.random.PRNGKey(0)))(**tree._asdict())
    return (JittedAgent(jcfg, jparams), jcfg,
            agent_params_from_jax(tree, cfg, device="cpu"), cfg)


def _obs(rng, cfg, B=None):
    lead = () if B is None else (B,)
    rgb = rng.integers(0, 256, lead + (12, cfg.clip.image_size,
                                       cfg.clip.image_size, 3), np.uint8)
    dep = rng.random(lead + (12, cfg.depth.input_size, cfg.depth.input_size,
                             1), np.float32)
    return rgb, dep


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    got = got.detach().cpu().numpy()
    if want.dtype == bool or want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], atol=atol)


def test_perceive_and_score_navigation_match_jax(agents, rng):
    jagent, jcfg, agent, cfg = agents
    rgb, dep = _obs(rng, cfg, B=2)
    jw, tw = jagent.perceive(rgb, dep), agent.perceive(rgb, dep)
    assert set(tw) == set(jw)
    for key in jw:
        _close(tw[key], jw[key])
    assert tw["cand_valid"].any()

    L, G = cfg.il.max_text_len, cfg.planner.max_gmap_len
    ids = rng.integers(1, cfg.planner.vocab_size, (1, L))
    tmask = np.arange(L)[None] < 11
    jt, tt = jagent.encode_text(ids, tmask), agent.encode_text(ids, tmask)
    _close(tt, jt)
    gmap = {"img_fts": rng.standard_normal((2, G, 64)).astype(np.float32),
            "step_ids": rng.integers(0, 4, (2, G)).astype(np.int32),
            "pos_fts": rng.standard_normal((2, G, 7)).astype(np.float32),
            "mask": np.arange(G)[None] < np.array([[G], [6]]),
            "visited": np.tile((np.arange(G) >= 1) & (np.arange(G) < 3),
                               (2, 1)),
            "pair_dists": rng.random((2, G, G)).astype(np.float32)}
    txt = np.repeat(np.asarray(jt), 2, axis=0)
    txt_m = np.repeat(tmask, 2, axis=0)
    jn = jagent.score_navigation(txt, txt_m, gmap)
    tn = agent.score_navigation(txt, txt_m, gmap)
    _close(tn["global_logits"], jn["global_logits"])
    _close(tn["gmap_embeds"], jn["gmap_embeds"])


def test_uint16_depth_dequantizes_on_device(agents, rng):
    """uint16 depth transport: the port dequantizes by 1/65535 before the
    depth trunk, so quantized depth gives what its float value gives."""
    *_, agent, cfg = agents
    rgb, dep = _obs(rng, cfg, B=1)
    q = np.round(dep * 65535.0).astype(np.uint16)
    got = agent.perceive(rgb, q)
    want = agent.perceive(rgb, (q.astype(np.float32) / 65535.0))
    for key in ("heatmap", "pano_embeds", "dep_fts"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-6)


def test_nav_server_actions_match_jax(agents):
    """2 sessions x 3 steps, stepped one request at a time so both
    servers see the same batches; identical observations; each session's
    next position is its last `ghost_pos`."""
    jagent, jcfg, agent, cfg = agents
    jserver = JaxNavServer(jcfg, jagent, max_batch=2, max_wait_ms=1.0)
    tserver = NavServer(cfg, agent, max_batch=2, max_wait_ms=1.0)
    try:
        assert tserver.warmup() == jserver.warmup() == 3
        rng = np.random.default_rng(5)
        toks = [rng.integers(1, cfg.planner.vocab_size, 9) for _ in range(2)]
        sids = [(jserver.create_session(t), tserver.create_session(t))
                for t in toks]
        pos = [np.zeros(3), np.array([1.0, 0.0, -2.0])]
        ori = np.array([0.0, 0.0, 0.0, 1.0])
        done = [False, False]
        n_compared, n_moves = 0, 0
        for step in range(3):
            for s in range(2):
                if done[s]:
                    continue
                rgb, dep = _obs(rng, cfg)
                jr = jserver.step(sids[s][0], rgb, dep, pos[s], ori)
                tr = tserver.step(sids[s][1], rgb, dep, pos[s], ori)
                ja, ta = jr["action"], tr["action"]
                assert ta["act"] == ja["act"], (step, s)
                assert tr["done"] == jr["done"]
                assert (tr["num_nodes"], tr["num_ghosts"]) == (
                    jr["num_nodes"], jr["num_ghosts"])
                np.testing.assert_allclose(tr["stop_prob"], jr["stop_prob"],
                                           atol=1e-5)
                # positions to 1e-5 m: candidate angles are fp32, and XLA
                # folds 2*pi*k/120 into other roundings (~5e-7 rad, ~1e-6 m
                # at a 3 m candidate)
                for key in ("stop_pos", "front_pos", "ghost_pos"):
                    if key in ja:
                        np.testing.assert_allclose(ta[key], ja[key],
                                                   atol=1e-5)
                if ja["act"] == 4:
                    pos[s] = np.asarray(ja["ghost_pos"], np.float64)
                    n_moves += 1
                done[s] = jr["done"]
                n_compared += 1
        assert n_compared == 6 and n_moves >= 2
        for js, ts in sids:
            jh, th = jserver.close_session(js), tserver.close_session(ts)
            assert jh["steps"] == th["steps"]
        assert tserver.stats()["steps_served"] == n_compared
    finally:
        jserver.shutdown()
        tserver.shutdown()


def test_agent_and_server_raise_without_gpu(monkeypatch):
    """The device is explicit: with no GPU, the default device raises and
    only device='cpu' runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Agent(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NavServer(cfg)
    server = NavServer(cfg, device="cpu", max_batch=1)
    try:
        assert server.agent.device.type == "cpu"
    finally:
        server.shutdown()


def _port_files():
    files = sorted((ROOT / "etpnav_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No `import jax...` / `import etpnav_tpu...` (the JAX package) in
    the port or chip_smoke.py, and importing the whole port in a fresh
    process loads neither, nor PyYAML or transformers."""
    bad = []
    files = _port_files()
    assert len(files) > 20
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"etpnav_tpu_torch/ops/fused_groupnorm.py",
            "etpnav_tpu_torch/ops/fused_prenorm.py",
            "etpnav_tpu_torch/training/finetune.py",
            "etpnav_tpu_torch/training/checkpoints.py",
            "etpnav_tpu_torch/env/geometric.py",
            "etpnav_tpu_torch/env/protocol.py",
            "etpnav_tpu_torch/metrics.py",
            "etpnav_tpu_torch/utils/trajectory.py",
            "etpnav_tpu_torch/ops/fused_block.py",
            "etpnav_tpu_torch/ops/fused_attention.py",
            "etpnav_tpu_torch/tools/__init__.py",
            "etpnav_tpu_torch/tools/exp_attn_layout.py",
            "etpnav_tpu_torch/tools/exp_attn_pack.py",
            "etpnav_tpu_torch/config_yaml.py",
            "etpnav_tpu_torch/convert_cli.py",
            "etpnav_tpu_torch/run.py",
            "etpnav_tpu_torch/serving_http.py",
            "etpnav_tpu_torch/data/episodes.py",
            "etpnav_tpu_torch/data/tokenization.py",
            "etpnav_tpu_torch/models/tree.py",
            "etpnav_tpu_torch/training/eval_loop.py",
            "etpnav_tpu_torch/training/pretrain.py",
            "etpnav_tpu_torch/training/warm_start.py",
            "etpnav_tpu_torch/data/pretrain_data.py",
            "etpnav_tpu_torch/utils/logging.py",
            "etpnav_tpu_torch/env/vector.py",
            "etpnav_tpu_torch/env/shm_transport.py",
            "etpnav_tpu_torch/env/habitat_adapter.py",
            "etpnav_tpu_torch/env/habitat_config.py",
            "etpnav_tpu_torch/env/habitat_worker.py",
            "etpnav_tpu_torch/env/worker_main.py",
            "etpnav_tpu_torch/training/pipeline.py",
            "etpnav_tpu_torch/training/dagger.py",
            "etpnav_tpu_torch/models/cma.py",
            "etpnav_tpu_torch/models/rec_vlnbert.py",
            "etpnav_tpu_torch/tools/learning_demo.py",
            "etpnav_tpu_torch/tools/record_convergence.py",
            "etpnav_tpu_torch/tools/pretrain_synth.py",
            "etpnav_tpu_torch/tools/warm_vs_cold.py",
            "etpnav_tpu_torch/tools/learn_ab.py",
            "etpnav_tpu_torch/data/feature_pipeline.py",
            "etpnav_tpu_torch/ops/image.py",
            "etpnav_tpu_torch/models/imagenet_resnet.py",
            "etpnav_tpu_torch/utils/aux_losses.py"} <= names
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "etpnav_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in files if p.name != "chip_smoke.py"]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'etpnav_tpu')]\n"
              "assert not bad, bad\n"
              # the runner and the tokenizer import these lazily
              "lazy = [m for m in ('yaml', 'transformers') "
              "if m in sys.modules]\n"
              "assert not lazy, lazy\nprint('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_trajectory_utils_match_jax():
    """`densify_path` and `unique_consecutive` (the port's copy of
    `etpnav_tpu/utils/trajectory.py`), as tests/test_eval_loop.py's
    `test_trajectory_utils` holds them, and equal to the JAX package's."""
    from etpnav_tpu.utils import trajectory as jtraj
    from etpnav_tpu_torch.utils.trajectory import (
        camera_orientations_12,
        densify_path,
        unique_consecutive,
    )
    path = np.array([[0, 0, 0], [1, 0, 0]], float)
    dense = densify_path(path, 0.25)
    assert len(dense) >= 5
    seg = np.linalg.norm(np.diff(dense, axis=0), axis=1)
    assert (seg <= 0.25 + 1e-9).all()
    rig = camera_orientations_12()
    assert len(rig) == 12 and rig[""][1] == 0.0
    assert unique_consecutive([[0, 0], [0, 0], [1, 1]]) == [[0, 0], [1, 1]]
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.normal(0, 0.7, (6, 3)), axis=0)
    for p in (walk, walk[:1], np.repeat(walk[:3], 2, axis=0)):
        for amount in (0.25, 0.4):
            np.testing.assert_array_equal(densify_path(p, amount),
                                          jtraj.densify_path(p, amount))
    pts = [list(p) for p in np.round(rng.random((12, 2)) * 2)]
    assert unique_consecutive(pts) == jtraj.unique_consecutive(pts)
