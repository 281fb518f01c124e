"""The port's eval videos (`utils/visualization.py`, the rollout's frame
recording and `FinetuneTrainer.evaluate(video_dir=...)`) against
`etpnav_tpu/utils/visualization.py` on the CPU.

- the two frame tests of `tests/test_feature_pipeline.py` (the top-down
  render, the navigator frame, the planner frame over a topological
  map's edges and ghosts): every frame equal to the JAX package's pixel
  for pixel, and `generate_video` writing under the same name;
- `evaluate(video_dir=...)` at `tiny_config()` writes one video per
  evaluated episode, named `episode{id}-spl{..}-ndtw{..}` (an mp4, or a
  directory of PNG frames where cv2 has no mp4 codec) from that
  episode's own metrics, as the JAX rollout names it;
- `run.py --run-type eval --video` writes them to `VIDEO_DIR`.
"""

import os
import re

import numpy as np
import pytest
import torch

from etpnav_tpu.graph.topo_map import TopoMap as JaxTopoMap
from etpnav_tpu.utils import visualization as jvis
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.graph.topo_map import TopoMap
from etpnav_tpu_torch.training.finetune import FinetuneTrainer
from etpnav_tpu_torch.utils import visualization as vis

torch.set_num_threads(2)


def _video_files(directory) -> list:
    return sorted(os.listdir(directory))


def test_visualization(tmp_path):
    kwargs = dict(agent_pos=[0, 0, 0], gt_path=[[0, 0, 0], [1, 0, -2]],
                  nodes=[[0, 0, 0]], ghosts=[[1, 0, -1]], goal=[2, 0, -3],
                  trajectory=[[0, 0, 0], [0.5, 0, -0.5]],
                  edges=[([0, 0, 0], [1, 0, -1])], predict_ghost=[1, 0, -1],
                  teacher_ghost=[0, 0, -1])
    frame = vis.TopDownRenderer(size=128, extent=5.0).render(**kwargs)
    want = jvis.TopDownRenderer(size=128, extent=5.0).render(**kwargs)
    assert frame.shape == (128, 128, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, want)

    rgb = np.random.default_rng(0).integers(0, 256, (12, 16, 16, 3),
                                            dtype=np.uint8)
    nav = vis.navigator_video_frame(
        {"rgb": rgb}, renderer=vis.TopDownRenderer(size=128, extent=5.0),
        agent_pos=[0, 0, 0])
    jnav = jvis.navigator_video_frame(
        {"rgb": rgb}, renderer=jvis.TopDownRenderer(size=128, extent=5.0),
        agent_pos=[0, 0, 0])
    assert nav.shape[1] == 12 * 128
    np.testing.assert_array_equal(nav, jnav)
    # no panorama: the map alone
    np.testing.assert_array_equal(
        vis.navigator_video_frame({}, agent_pos=[1, 0, 1]),
        jvis.navigator_video_frame({}, agent_pos=[1, 0, 1]))

    path = vis.generate_video([nav, nav], str(tmp_path / "vid"), "7",
                              {"spl": 0.5})
    jpath = jvis.generate_video([jnav, jnav], str(tmp_path / "jvid"), "7",
                                {"spl": 0.5})
    assert os.path.exists(path)
    assert os.path.basename(path) == os.path.basename(jpath)
    assert re.fullmatch(r"episode7-spl0\.50(\.mp4)?",
                        os.path.basename(path))


def _two_node_map(cls):
    m = cls()
    n0 = m.update(None, 0, np.zeros(3), np.array([0, 0, 0, 1.0]),
                  np.zeros(8), np.array([0.0, 1.57]),
                  np.array([1.5, 1.5]), np.zeros((2, 8)),
                  np.zeros((2,), np.int32), 0)
    n1 = m.update(n0, 1, np.array([1.5, 0, 0]), np.array([0, 0, 0, 1.0]),
                  np.zeros(8), np.array([0.0]), np.array([1.5]),
                  np.zeros((1, 8)), np.zeros((1,), np.int32), 1)
    return m, n0, n1


def test_planner_frame_with_graph_edges():
    """planner_video_frame over the port's TopoMap (edges from its
    edge_list, the predicted ghost) equals the JAX package's frame over
    its TopoMap, pixel for pixel."""
    frames = []
    for mod, cls in ((vis, TopoMap), (jvis, JaxTopoMap)):
        m, n0, n1 = _two_node_map(cls)
        edges = m.edge_list()
        assert (min(n0, n1), max(n0, n1)) in edges
        frames.append(mod.planner_video_frame(
            {"rgb": np.full((12, 16, 16, 3), 90, np.uint8)},
            renderer=mod.TopDownRenderer(size=128, extent=5.0),
            agent_pos=[0, 0, 0], nodes=list(m.node_pos),
            edges=[(m.node_pos[u], m.node_pos[v]) for u, v in edges],
            ghosts=[g.aug_pos for g in m.ghosts.values()],
            predict_ghost=next(iter(m.ghosts.values())).aug_pos))
    frame, want = frames
    assert frame.shape == (12 * 64 + 64, 12 * 64, 3)
    np.testing.assert_array_equal(frame, want)
    assert (frame[:12 * 64] != 255).any()        # the graph was drawn


@pytest.fixture(scope="module")
def trainer():
    cfg = tiny_config()
    envs = GeometricNavEnv(num_envs=2, seed=0,
                           vocab_size=cfg.planner.vocab_size,
                           max_instr_len=cfg.il.max_text_len,
                           image_size=cfg.clip.image_size,
                           depth_size=cfg.depth.input_size,
                           pad_id=cfg.planner.pad_token_id)
    return FinetuneTrainer(cfg, envs, seed=0, device="cpu")


def test_eval_writes_videos(trainer, tmp_path):
    """One video per evaluated episode, named from its own metrics."""
    stat: dict = {}
    vdir = tmp_path / "engine"
    trainer.engine.run("eval", stat_eps=stat, video_dir=str(vdir))
    assert stat
    names = _video_files(vdir)
    want = sorted(f"episode{eid}-spl{m['spl']:.2f}-ndtw{m['ndtw']:.2f}"
                  for eid, m in stat.items())
    assert [re.sub(r"\.mp4$", "", n) for n in names] == want
    for n in names:
        p = vdir / n
        if p.is_dir():               # no mp4 codec: a directory of frames
            frames = sorted(os.listdir(p))
            assert frames and all(f.endswith(".png") for f in frames)
        else:
            assert p.stat().st_size > 0

    stats = trainer.evaluate(episode_count=2, video_dir=str(tmp_path / "v"))
    assert len(_video_files(tmp_path / "v")) == stats["n_episodes"] == 2


def test_run_video(tmp_path):
    from etpnav_tpu_torch.run import run
    exp = tmp_path / "exp.yaml"
    exp.write_text("BASE: tiny\n")
    vdir = tmp_path / "videos"
    stats = run(["--exp-config", str(exp), "--device", "cpu", "--num-envs",
                 "2", "--run-type", "eval", "--video", "--episode-count",
                 "2", f"VIDEO_DIR={vdir}"])
    names = _video_files(vdir)
    assert len(names) == stats["n_episodes"] == 2
    assert all(re.fullmatch(r"episode\d+-spl\d\.\d\d-ndtw\d\.\d\d"
                            r"(\.mp4)?", n) for n in names), names
