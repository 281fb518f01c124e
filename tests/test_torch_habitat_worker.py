"""The port's habitat adapter (`etpnav_tpu_torch/env/habitat_worker.py`,
`habitat_config.py`, `habitat_adapter.py`) on the mock habitat API of
tests/test_habitat_worker.py, imported from there so both packages run
against the same mock: every case of that file except its two DAgger
cases (DAgger is not ported), each with the port's modules; a parity
case that steps the JAX package's worker and the port's through the same
actions and holds observations, poses, infos and oracle answers equal
(np.array_equal / exact floats); and the port's worker factory, which
plain pickle moves to a forkserver worker.
"""

import math
import pickle
import sys
import types

import numpy as np
import pytest

from test_habitat_worker import (
    FORWARD,
    _EpisodeMeta,
    _EpisodeMeta2,
    _make_obs,
    _MockEnv,
    _framework_episodes as _jax_framework_episodes,
    _mock_task_config,
)


def _fake_habitat(monkeypatch, env=_MockEnv):
    fake = types.ModuleType("habitat")
    fake.Env = env
    monkeypatch.setitem(sys.modules, "habitat", fake)


def _framework_episodes():
    """tests/test_habitat_worker.py's episodes as the port's Episode."""
    import dataclasses

    from etpnav_tpu_torch.env.protocol import Episode
    return [Episode(**{f.name: getattr(e, f.name)
                       for f in dataclasses.fields(e)})
            for e in _jax_framework_episodes()]


@pytest.fixture()
def worker(monkeypatch):
    _fake_habitat(monkeypatch)
    from etpnav_tpu_torch.env.habitat_worker import HabitatWorkerEnv
    return HabitatWorkerEnv(None, seed=0)


def test_reset_packs_12_camera_rig(worker):
    obs = worker.reset()
    assert len(obs) == 1
    assert obs[0]["rgb"].shape == (12, 8, 8, 3)
    assert obs[0]["depth"].shape == (12, 4, 4, 1)
    # view v comes from camera rgb_v (ccw rig order)
    assert (obs[0]["rgb"][3] == 3).all()
    pos, ori = worker.get_pos_ori()
    assert pos.shape == (1, 3) and ori.shape == (1, 4)


def test_control_reaches_ghost_without_teleport(worker):
    worker.reset()
    target = np.array([-1.0, 0.0, -2.0])
    res = worker.step([{"act": 4, "front_pos": None, "ghost_pos": target,
                        "back_path": [(0, np.array([0.0, 0.0, -1.0]))],
                        "tryout": True}])[0]
    assert not res.done
    end = worker._env.sim.pos
    # quantized 15-deg turns + 0.25m steps land within one step of target
    assert np.linalg.norm(end - target) < 2 * FORWARD + 0.3
    assert worker._env.sim.step_calls > 4      # real micro-stepping


def test_stop_records_info(worker):
    worker.reset()
    res = worker.step([{"act": 0, "stop_pos": np.zeros(3),
                        "back_path": None, "tryout": True}])[0]
    assert res.done
    info = res.info
    assert info["steps_taken"] >= 0
    assert len(info["position"]["position"]) == len(
        info["position"]["distance"])
    assert info["position_infer"]["position"]


def test_cand_real_pos_preserves_state(worker):
    worker.reset()
    sim = worker._env.sim
    sim.pos = np.array([1.0, 0.0, 1.0])
    sim.heading = 0.4
    before_pos, before_head = sim.pos.copy(), sim.heading
    out = worker.cand_real_pos(0, [0.0, math.pi / 2], [1.0, 0.5])
    assert out.shape == (2, 3)
    np.testing.assert_allclose(sim.pos, before_pos)
    assert sim.heading == pytest.approx(before_head, abs=1e-9)
    # candidate 0: straight ahead ~1m (4 forward steps)
    assert np.linalg.norm(out[0] - before_pos) == pytest.approx(
        4 * FORWARD, abs=1e-6)


def test_tryout_recovers_from_collision(monkeypatch):
    _fake_habitat(monkeypatch,
                  lambda config=None: _MockEnv(config, wall_z=-1.2))
    from etpnav_tpu_torch.env.habitat_worker import HabitatWorkerEnv
    w = HabitatWorkerEnv(None, seed=0)
    w.reset()
    # target straight through the wall: forward collides, tryout turns
    res = w.step([{"act": 4, "front_pos": np.zeros(3),
                   "ghost_pos": np.array([0.0, 0.0, -3.0]),
                   "back_path": None, "tryout": True}])[0]
    assert not res.done
    assert w._collisions >= 1
    # tryout moved the agent off the straight-line axis
    assert abs(w._env.sim.pos[0]) > 1e-6


def test_oracles(worker):
    worker.reset()
    d = worker.current_dist_to_goal()
    assert d.shape == (1,) and d[0] == pytest.approx(5.0)
    assert worker.point_dist_to_goal(0, [0, 0, -4.0]) == pytest.approx(1.0)
    # progress-tracked subgoal: with the agent near the end of the ref
    # path, the subgoal is ref[-1] and the ghost nearest it wins
    worker._env.sim.pos = np.array([0.0, 0.0, -4.5])
    ghosts = np.array([[0.0, 0.0, -4.9], [3.0, 0.0, 3.0]])
    k = worker.ghost_dist_to_ref(0, ghosts, _EpisodeMeta.reference_path)
    assert k == 0
    # progress is monotonic WITHIN an episode (environments.py:158-162):
    # teleporting back to the start keeps the near-end subgoal
    worker._env.sim.pos = np.zeros(3)
    k = worker.ghost_dist_to_ref(0, ghosts, _EpisodeMeta.reference_path)
    assert k == 0
    # a new episode resets the progress: at the start the subgoal is
    # ref[0] and the closer-to-start ghost wins (ndtw expert semantics,
    # ss_trainer_ETP.py:287-301)
    worker._env.current_episode = _EpisodeMeta2()
    k = worker.ghost_dist_to_ref(0, ghosts, _EpisodeMeta.reference_path)
    assert k == 1


def test_episodes_allowed_filter(monkeypatch):
    _fake_habitat(monkeypatch)
    from etpnav_tpu_torch.env.habitat_worker import HabitatWorkerEnv
    w = HabitatWorkerEnv(None, seed=0, episodes_allowed=["9"])
    assert [e.episode_id for e in w._env.episodes] == [9]


def test_vector_pool_over_mock(monkeypatch):
    _fake_habitat(monkeypatch)
    from etpnav_tpu_torch.env.habitat_worker import HabitatVectorEnv
    env = HabitatVectorEnv(None, num_envs=2, scenes=["a", "b", "c"],
                           threaded=True)
    assert env.num_envs == 2
    obs = env.reset()
    assert len(obs) == 2 and obs[0]["rgb"].shape == (12, 8, 8, 3)
    pos, ori = env.get_pos_ori()
    assert pos.shape == (2, 3)
    res = env.step([{"act": 0, "stop_pos": np.zeros(3), "back_path": None,
                     "tryout": True}] * 2)
    assert all(r.done for r in res)


def test_shard_scenes_round_robin():
    from etpnav_tpu_torch.env.habitat_adapter import shard_scenes
    shards = shard_scenes(["d", "b", "a", "c", "e"], 2)
    assert shards == [["a", "c", "e"], ["b", "d"]]
    shards = shard_scenes(["a", "b"], 4)
    assert [s[0] for s in shards] == ["a", "b", "a", "b"]


# ---------------------------------------------------------------------------
# TASK-config surgery (habitat_config.py; reference ss_trainer_ETP.py:85-123)
# ---------------------------------------------------------------------------

def test_inject_camera_rig():
    from etpnav_tpu_torch.env.habitat_config import inject_camera_rig
    tc = _mock_task_config()
    inject_camera_rig(tc, rgb_size=224, depth_size=256)
    sim = tc.SIMULATOR
    # 2 base + 22 injected sensors, registered on the agent
    assert len(sim.AGENT_0.SENSORS) == 24
    for v in range(1, 12):
        cam = getattr(sim, f"RGB_{v}")
        assert cam.UUID == f"rgb_{v}"
        assert cam.WIDTH == cam.HEIGHT == 224
        # ccw yaw, 30-degree increments (common/utils.py:62-67)
        assert cam.ORIENTATION[1] == pytest.approx(2 * math.pi * v / 12)
        dcam = getattr(sim, f"DEPTH_{v}")
        assert dcam.UUID == f"depth_{v}"
        assert dcam.WIDTH == dcam.HEIGHT == 256
    # distinct configs, not aliases of the base sensor
    assert sim.RGB_1 is not sim.RGB_SENSOR
    assert sim.RGB_1.ORIENTATION != sim.RGB_2.ORIENTATION
    # idempotent on the sensor list
    inject_camera_rig(tc)
    assert len(sim.AGENT_0.SENSORS) == 24


def test_make_vlnce_task_config():
    import dataclasses

    from etpnav_tpu_torch.config import DataPathsConfig, tiny_config
    from etpnav_tpu_torch.env.habitat_config import make_vlnce_task_config
    cfg = dataclasses.replace(
        tiny_config(),
        paths=DataPathsConfig(
            data_path="data/{split}/{split}.json.gz",
            scenes_dir="data/scene_datasets/",
            gt_path="data/{split}_gt.json.gz"))
    tc = make_vlnce_task_config(cfg, split="val_unseen",
                                base=_mock_task_config())
    assert tc.SIMULATOR.FORWARD_STEP_SIZE == 0.25
    assert tc.SIMULATOR.TURN_ANGLE == 15
    assert tc.SIMULATOR.HABITAT_SIM_V0.ALLOW_SLIDING is True
    assert tc.SIMULATOR.RGB_SENSOR.WIDTH == cfg.clip.image_size
    assert tc.SIMULATOR.DEPTH_SENSOR.WIDTH == cfg.depth.input_size
    assert len(tc.SIMULATOR.AGENT_0.SENSORS) == 24
    assert tc.DATASET.TYPE == "VLN-CE-v1"
    assert tc.DATASET.SPLIT == "val_unseen"
    assert tc.DATASET.DATA_PATH == "data/{split}/{split}.json.gz"
    assert tc.TASK.NDTW.GT_PATH == "data/{split}_gt.json.gz"
    assert tc.TASK.NDTW.SPLIT == "val_unseen"


def test_pack_obs_missing_rig_is_hard_error(worker):
    """Without the injected rig, the old code silently ran the model on
    12 copies of the forward camera; now it refuses (VERDICT r1 Weak #5)."""
    obs = {"rgb": np.zeros((8, 8, 3), np.uint8),
           "depth": np.zeros((4, 4, 1), np.float32),
           "instruction": np.arange(3)}
    with pytest.raises(KeyError, match="rig"):
        worker._pack_obs(obs)
    # one missing view is also fatal
    obs = _make_obs()
    del obs["rgb_7"]
    with pytest.raises(KeyError, match="rgb_7"):
        worker._pack_obs(obs)


# ---------------------------------------------------------------------------
# episode injection (habitat_config.EpisodeDataset; replaces the
# reference's registry-side dataset types, habitat_extensions/task.py:48)
# ---------------------------------------------------------------------------

def test_worker_episode_injection(monkeypatch):
    _fake_habitat(monkeypatch)
    from etpnav_tpu_torch.env.habitat_worker import HabitatWorkerEnv
    eps = _framework_episodes()
    w = HabitatWorkerEnv(None, episodes=eps[:2], seed=0)
    assert [e.episode_id for e in w._env.episodes] == ["0", "1"]
    cur = w.current_episodes()[0]
    assert cur.instruction_text == "ep 0"
    assert cur.instruction_tokens.tolist() == [0, 1, 2, 3]
    np.testing.assert_allclose(cur.goal_position, [0.0, 0.0, -5.0])
    # start_heading is recovered from the episode's start_rotation, not
    # hardcoded (heading_to_quat/heading_from_quaternion round-trip)
    w2 = HabitatWorkerEnv(None, episodes=[eps[2]], seed=0)
    assert abs(w2.current_episodes()[0].start_heading - 0.5) < 1e-9
    # empty injection is rejected loudly
    with pytest.raises(ValueError, match="no episodes"):
        HabitatWorkerEnv(None, episodes=[], seed=0)


def test_episode_iterator_options():
    """get_episode_iterator honors habitat's ITERATOR_OPTIONS (cycle /
    shuffle / group_by_scene / seed) instead of silently replaying a
    fixed order forever."""
    import itertools

    from etpnav_tpu_torch.env.habitat_config import EpisodeDataset
    ds = EpisodeDataset(_framework_episodes())
    n = len(ds.episodes)

    # cycle=False is finite and covers every episode exactly once
    once = list(ds.get_episode_iterator(cycle=False, shuffle=False))
    assert [e.episode_id for e in once] == sorted(
        [e.episode_id for e in ds.episodes])
    ordered = list(ds.get_episode_iterator(cycle=False, shuffle=False,
                                           group_by_scene=False))
    assert [e.episode_id for e in ordered] == [e.episode_id
                                               for e in ds.episodes]

    # shuffle reorders between epochs (deterministically under seed)
    it = ds.get_episode_iterator(cycle=True, shuffle=True, seed=3)
    epoch1 = [e.episode_id for e in itertools.islice(it, n)]
    epoch2 = [e.episode_id for e in itertools.islice(it, n)]
    assert sorted(epoch1) == sorted(epoch2)
    it_b = ds.get_episode_iterator(cycle=True, shuffle=True, seed=3)
    assert [e.episode_id for e in itertools.islice(it_b, n)] == epoch1

    # group_by_scene keeps each scene's episodes contiguous
    it = ds.get_episode_iterator(cycle=True, shuffle=True,
                                 group_by_scene=True, seed=0)
    scenes = [e.scene_id for e in itertools.islice(it, n)]
    assert len([k for k, _ in itertools.groupby(scenes)]) == len(
        set(scenes))


def test_vector_pool_episode_sharding(monkeypatch):
    _fake_habitat(monkeypatch)
    from etpnav_tpu_torch.env.habitat_worker import HabitatVectorEnv
    eps = _framework_episodes()          # scenes scene0:{0,2} scene1:{1,3}
    env = HabitatVectorEnv(None, num_envs=2, episodes=eps, threaded=True)
    got = [{e.episode_id for e in w._env.episodes} for w in env._envs]
    assert got == [{"0", "2"}, {"1", "3"}]      # scene-sharded, disjoint
    env = HabitatVectorEnv(None, num_envs=2, episodes=eps,
                           episodes_allowed=["1", "2"], threaded=True)
    got = [{e.episode_id for e in w._env.episodes} for w in env._envs]
    assert got == [{"2"}, {"1"}]


# ---------------------------------------------------------------------------
# legacy low-level surface (CMA/DAgger path on habitat)
# ---------------------------------------------------------------------------

def test_step_low_level_and_teacher(worker):
    worker.reset()
    sim = worker._env.sim
    # teacher: goal straight ahead -> forward
    assert worker.shortest_path_action(0) == 1
    res = worker.step_low_level([1])[0]
    assert not res.done
    assert np.linalg.norm(sim.pos - [0, 0, -FORWARD]) < 1e-9
    assert res.observation["rgb"].shape == (12, 8, 8, 3)
    # face 90 degrees left of the goal -> teacher turns right
    sim.heading = math.pi / 2
    assert worker.shortest_path_action(0) == 3
    before = sim.pos.copy()
    worker.step_low_level([3])
    np.testing.assert_allclose(worker._env.sim.pos, before)  # pure turn
    # STOP ends the episode with full info
    res = worker.step_low_level([0])[0]
    assert res.done and res.info["steps_taken"] >= 2
    # at the goal, the teacher stops
    sim.pos = np.array([0.0, 0.0, -4.9])
    assert worker.shortest_path_action(0, goal_radius=0.5) == 0


# ---------------------------------------------------------------------------
# the port against the JAX package's worker on the same mock
# ---------------------------------------------------------------------------

def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_worker_matches_jax_on_the_same_mock(monkeypatch):
    """Reset, a ghost step with tryout into a wall, a low-level step, a
    stop, and every oracle: the port's worker answers what the JAX
    package's does."""
    _fake_habitat(monkeypatch,
                  lambda config=None: _MockEnv(config, wall_z=-1.2))
    from etpnav_tpu.env.habitat_worker import HabitatWorkerEnv as JaxWorker
    from etpnav_tpu_torch.env.habitat_worker import HabitatWorkerEnv
    ours, theirs = HabitatWorkerEnv(None, seed=0), JaxWorker(None, seed=0)
    _same(ours.reset()[0], theirs.reset()[0])
    ghost = {"act": 4, "front_pos": np.zeros(3),
             "ghost_pos": np.array([0.5, 0.0, -3.0]),
             "back_path": [(0, np.array([0.0, 0.0, -0.5]))],
             "tryout": True}
    stop = {"act": 0, "stop_pos": np.zeros(3), "back_path": None,
            "tryout": True}
    for step in (lambda w: w.step([dict(ghost)]),
                 lambda w: w.step_low_level([2]),
                 lambda w: w.get_pos_ori(),
                 lambda w: w.current_dist_to_goal(),
                 lambda w: w.progress(),
                 lambda w: w.point_dists_to_goal(0, [[0, 0, -4.0],
                                                     [1, 0, 1.0]]),
                 lambda w: w.cand_real_pos(0, [0.0, math.pi / 2],
                                           [1.0, 0.5]),
                 lambda w: w.ghost_dist_to_ref(
                     0, np.array([[0.0, 0.0, -4.9], [3.0, 0.0, 3.0]]),
                     _EpisodeMeta.reference_path),
                 lambda w: w.shortest_path_action(0),
                 lambda w: w.step([dict(stop)])):
        a, b = step(ours), step(theirs)
        if isinstance(a, list) and a and hasattr(a[0], "observation"):
            for ra, rb in zip(a, b):
                assert ra.done == rb.done
                _same(ra.observation, rb.observation)
                _same(ra.info, rb.info)
        else:
            _same(a, b)
    assert ours._collisions == theirs._collisions >= 1


def test_pool_factories_travel_by_plain_pickle(monkeypatch):
    """The pool's per-worker factories are objects plain pickle moves
    (a forkserver worker needs that); each builds its shard's worker."""
    _fake_habitat(monkeypatch)
    from etpnav_tpu_torch.env.habitat_worker import (
        HabitatVectorEnv,
        HabitatWorkerEnv,
        HabitatWorkerFactory,
    )
    env = HabitatVectorEnv(None, num_envs=2, episodes=_framework_episodes(),
                           threaded=True)
    factories = env._factories
    assert all(isinstance(f, HabitatWorkerFactory) for f in factories)
    moved = [pickle.loads(pickle.dumps(f)) for f in factories]
    assert [f.seed for f in moved] == [0, 1]
    w = moved[1]()
    assert isinstance(w, HabitatWorkerEnv)
    assert {e.episode_id for e in w._env.episodes} == {"1", "3"}
