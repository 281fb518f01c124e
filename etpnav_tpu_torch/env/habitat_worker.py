"""Habitat-sim worker env implementing the VectorNavEnv protocol
(counterpart of `etpnav_tpu/env/habitat_worker.py`).

Production adapter (requires habitat-lab v0.1.7-compatible API +
habitat-sim; neither is in CI — this module is only imported through
env/habitat_adapter.py's availability gate).

Maps the framework's batched protocol onto habitat primitives exactly the
way the reference's env layer does:
- obs-free physics stepping for low-level control
  (habitat_extensions/habitat_simulator.py:62-93 step_without_obs)
- quantized turn / 0.25m forward micro-steps with the collision tryout
  recovery (common/environments.py:340-421)
- state-preserving candidate oracles via set_agent_state round-trips
  (common/environments.py:121-143)
- geodesic_distance for teacher supervision (:108-119)

One HabitatWorkerEnv hosts one habitat.Env (scene-sharded by the caller);
ProcessVectorEnv (env/vector.py) provides the worker pool + batched RPC.
"""

from __future__ import annotations

import math
import random
from typing import List, Sequence

import numpy as np

from etpnav_tpu_torch.env.geometric import (
    TRYOUT_LEFT_FIRST,
    TRYOUT_RIGHT_FIRST,
    heading_to_quat,
)
from etpnav_tpu_torch.env.protocol import Episode, StepResult
from etpnav_tpu_torch.graph.geometry import heading_from_quaternion

FORWARD_M = 0.25
TURN_DEG = 15.0


class HabitatWorkerEnv:
    """Single habitat env behind the VectorNavEnv protocol (num_envs=1)."""

    def __init__(self, habitat_config, episodes: Sequence[Episode] = None,
                 seed: int = 0, episodes_allowed: Sequence[str] = None):
        import habitat
        self._cfg = habitat_config
        if episodes is not None:
            # direct episode injection from data/episodes.py records —
            # replaces the reference's registry-registered dataset types
            # (habitat_extensions/task.py:48,135)
            from etpnav_tpu_torch.env.habitat_config import (
                episodes_to_habitat_dataset)
            self._env = habitat.Env(
                config=habitat_config,
                dataset=episodes_to_habitat_dataset(episodes))
        else:
            self._env = habitat.Env(config=habitat_config)
        self._env.seed(seed)
        if episodes_allowed is not None:
            # EPISODES_ALLOWED filter (construct_envs episodes_allowed,
            # env_utils.py:43-50 / task.py EPISODES_ALLOWED)
            allowed = {str(e) for e in episodes_allowed}
            eps = [ep for ep in getattr(self._env, "episodes", [])
                   if str(ep.episode_id) in allowed]
            if not eps:
                raise ValueError(
                    "episodes_allowed matched no episode in this worker's"
                    f" shard ({len(allowed)} ids requested) — running the"
                    " full split instead would silently report the wrong"
                    " subset")
            self._env.episodes = eps
        self._rng = random.Random(seed)
        self._paused = False
        self._positions: List[np.ndarray] = []
        self._headings: List[float] = []
        self._collisions = 0
        self._steps = 0

    # ---- protocol plumbing (single env) ----

    @property
    def num_envs(self) -> int:
        return 0 if self._paused else 1

    def pause_at(self, idx: int):
        self._paused = True

    def resume_all(self):
        self._paused = False

    def current_episodes(self):
        ep = self._env.current_episode
        instr = getattr(ep, "instruction", None)
        return [Episode(
            episode_id=str(ep.episode_id),
            scene_id=ep.scene_id,
            instruction_tokens=np.asarray(
                getattr(instr, "instruction_tokens", []), np.int64),
            instruction_text=getattr(instr, "instruction_text", ""),
            start_position=np.asarray(ep.start_position),
            start_heading=float(heading_from_quaternion(
                np.asarray(ep.start_rotation, np.float64))),
            goal_position=np.asarray(ep.goals[0].position),
            reference_path=[np.asarray(p) for p in
                            getattr(ep, "reference_path", [])],
        )]

    # ---- sim primitives ----

    def _sim(self):
        return self._env.sim

    def _state(self):
        return self._sim().get_agent_state()

    def _log_pose(self):
        s = self._state()
        self._positions.append(np.asarray(s.position))
        q = s.rotation
        self._headings.append(heading_from_quaternion(
            np.array([q.x, q.y, q.z, q.w])))

    def _step_without_obs(self, action: int):
        """Physics step, no sensor render (Sim-v1 extension,
        habitat_simulator.py:62-93). Falls back to env-level step when the
        simulator lacks the extension."""
        sim = self._sim()
        if hasattr(sim, "step_without_obs"):
            sim.step_without_obs(action)
        else:
            sim.step(action)
        self._steps += 1
        self._log_pose()

    def _forward_once(self) -> bool:
        self._step_without_obs(1)   # MOVE_FORWARD
        collided = bool(getattr(self._sim(), "previous_step_collided",
                                False))
        self._collisions += int(collided)
        return collided

    def _turn(self, ang_rad: float):
        deg = round(math.degrees(ang_rad) / TURN_DEG) * TURN_DEG
        if 180 < deg <= 360:
            deg -= 360
        n = abs(int(deg // TURN_DEG))
        action = 2 if deg >= 0 else 3   # TURN_LEFT / TURN_RIGHT
        for _ in range(n):
            self._step_without_obs(action)

    def _teleport(self, pos):
        self._sim().set_agent_state(list(map(float, pos)),
                                    heading_to_quat(0.0).tolist())
        self._log_pose()

    def _rel_to(self, target) -> tuple:
        s = self._state()
        q = s.rotation
        heading = heading_from_quaternion(np.array([q.x, q.y, q.z, q.w]))
        d = np.asarray(target) - np.asarray(s.position)
        dist = math.hypot(d[0], d[2])
        ang_world = math.atan2(-d[0], -d[2])
        return (ang_world - heading) % (2 * math.pi), dist

    def _single_step_control(self, target, tryout: bool):
        rel, dist = self._rel_to(target)
        self._turn(rel)
        ksteps = int(dist // FORWARD_M)
        done = 0
        collided = False
        for _ in range(ksteps):
            if self._forward_once():
                collided = True
                break
            done += 1
        remaining = ksteps - done
        if tryout and collided and remaining > 0:
            left = self._rng.random() < 0.5
            self._turn(math.radians(90 if left else 270))
            for head, tail in (TRYOUT_LEFT_FIRST if left
                               else TRYOUT_RIGHT_FIRST):
                self._turn(math.radians(head))
                before = np.asarray(self._state().position)
                self._forward_once()
                if not np.allclose(before,
                                   np.asarray(self._state().position)):
                    self._turn(math.radians(tail))
                    for _ in range(remaining):
                        if self._forward_once():
                            break
                    break

    # ---- protocol: reset / step ----

    def reset(self):
        obs = self._env.reset()
        self._positions = []
        self._headings = []
        self._collisions = 0
        self._steps = 0
        self._log_pose()
        return [self._pack_obs(obs)]

    def _pack_obs(self, obs) -> dict:
        """Collect the 12-camera panorama into (12, H, W, C) arrays,
        counter-clockwise with view 0 forward (the reference assembles the
        same rig, ss_trainer_ETP.py:97-113).

        A missing per-view sensor is a HARD error: silently substituting
        the forward camera would run the model on 12 copies of one view
        (garbage) without ever failing — the rig must be injected via
        habitat_config.inject_camera_rig before workers start."""
        missing = [f"{kind}_{v}" for v in range(1, 12)
                   for kind in ("rgb", "depth")
                   if f"{kind}_{v}" not in obs]
        if "rgb" not in obs or "depth" not in obs or missing:
            raise KeyError(
                "panorama sensors missing from habitat observation: "
                f"{missing or ['rgb', 'depth']} — the 12-camera rig was "
                "not injected into the TASK config (use "
                "habitat_config.make_vlnce_task_config / "
                "inject_camera_rig)")
        rgb, dep = [], []
        for v in range(12):
            suffix = "" if v == 0 else f"_{v}"
            rgb.append(obs[f"rgb{suffix}"])
            dep.append(obs[f"depth{suffix}"])
        return {
            "rgb": np.stack(rgb),
            "depth": np.stack(dep),
            "instruction": np.asarray(
                obs.get("instruction", np.zeros(0)), np.int64),
        }

    def step(self, actions) -> List[StepResult]:
        action = actions[0]
        act = action["act"]
        if act == 4:
            if action.get("back_path") is None:
                self._teleport(action["front_pos"])
            else:
                for _vp, pos in action["back_path"]:
                    self._single_step_control(pos,
                                              action.get("tryout", True))
            self._single_step_control(action["ghost_pos"],
                                      action.get("tryout", True))
            s = self._state()
            obs = self._sim().get_observations_at(
                s.position, s.rotation, keep_agent_at_new_pose=True)
            done = False
            info = {}
        elif act == 0:
            if action.get("back_path") is None:
                self._teleport(action["stop_pos"])
            else:
                for _vp, pos in action["back_path"]:
                    self._single_step_control(pos,
                                              action.get("tryout", True))
            obs = self._env.step({"action": 0})  # STOP
            done = True
            info = self._info()
        else:
            raise NotImplementedError(act)
        return [StepResult(self._pack_obs(obs), done, info)]

    def step_low_level(self, actions) -> List[StepResult]:
        """Single discrete action (0 stop / 1 fwd / 2 left / 3 right)
        with a rendered observation — the legacy CMA/DAgger control
        surface (habitat_extensions/nav.py task actions drive the same
        primitives)."""
        act = int(actions[0])
        if act == 0:
            obs = self._env.step({"action": 0})      # STOP
            return [StepResult(self._pack_obs(obs), True, self._info())]
        if act == 1:
            self._forward_once()
        else:
            self._step_without_obs(act)              # TURN_LEFT/RIGHT
        s = self._state()
        obs = self._sim().get_observations_at(
            s.position, s.rotation, keep_agent_at_new_pose=True)
        return [StepResult(self._pack_obs(obs), False, {})]

    def shortest_path_action(self, env_idx: int,
                             goal_radius: float = 0.5) -> int:
        """Greedy geodesic teacher for low-level control (reference:
        ShortestPathSensor over habitat's follower, sensors.py:70-113).
        Prefers habitat's ShortestPathFollower; falls back to a
        state-preserving probe — pick the 15-degree heading whose next
        0.25 m step most reduces geodesic distance, then emit the first
        primitive action toward it."""
        sim = self._sim()
        goal = self._env.current_episode.goals[0].position
        if not hasattr(self, "_follower"):
            try:
                from habitat.tasks.nav.shortest_path_follower import (
                    ShortestPathFollower)
                self._follower = ShortestPathFollower(
                    sim, goal_radius, return_one_hot=False)
            except Exception as e:   # noqa: BLE001 — optional fast path
                # cache the failure: retrying the import/construction per
                # teacher query would add overhead to every DAgger step,
                # and the ~50-sim-call probe fallback should be visible
                self._follower = None
                import logging
                logging.getLogger("etpnav.habitat").warning(
                    "ShortestPathFollower unavailable (%s); using the "
                    "24-heading geodesic probe for teacher actions", e)
        if self._follower is not None:
            try:
                a = self._follower.get_next_action(goal)
                return 0 if a is None else int(a)
            except Exception:   # noqa: BLE001 — per-query follower fault
                pass
        init = self._state()
        if sim.geodesic_distance(init.position, goal) < goal_radius:
            return 0
        heading = heading_from_quaternion(np.array(
            [init.rotation.x, init.rotation.y, init.rotation.z,
             init.rotation.w]))
        best, best_d = 0, np.inf
        for k in range(-11, 13):                 # 15-degree headings
            ang = math.radians(15.0 * k)
            sim.set_agent_state(
                init.position,
                heading_to_quat((heading + ang) % (2 * math.pi)).tolist())
            if hasattr(sim, "step_without_obs"):
                sim.step_without_obs(1)
            else:
                sim.step(1)
            d = sim.geodesic_distance(sim.get_agent_state().position,
                                      goal)
            if d < best_d - 1e-9:
                best, best_d = k, d
            sim.set_agent_state(init.position, init.rotation)
        sim.set_agent_state(init.position, init.rotation)
        if best == 0:
            return 1                             # already aligned: forward
        return 2 if best > 0 else 3              # turn toward the heading

    def _info(self) -> dict:
        ep = self._env.current_episode
        goal = np.asarray(ep.goals[0].position)
        positions = np.stack(self._positions)
        dists = np.array([self._sim().geodesic_distance(p, goal)
                          for p in positions])
        return {
            "position": {"position": positions, "distance": dists},
            "position_infer": {
                "position": [list(map(float, p)) for p in self._positions],
                "heading": self._headings,
            },
            "steps_taken": self._steps,
            "collisions": {"count": self._collisions},
        }

    # ---- protocol: oracles ----

    def get_pos_ori(self):
        s = self._state()
        q = s.rotation
        return (np.asarray(s.position)[None],
                np.array([[q.x, q.y, q.z, q.w]]))

    def current_dist_to_goal(self) -> np.ndarray:
        ep = self._env.current_episode
        return np.array([self._sim().geodesic_distance(
            self._state().position, ep.goals[0].position)])

    def progress(self) -> np.ndarray:
        """(start_geo - current_geo) / start_geo
        (VLNOracleProgressSensor, sensors.py:116-163)."""
        ep = self._env.current_episode
        goal = ep.goals[0].position
        start = self._sim().geodesic_distance(ep.start_position, goal)
        cur = self._sim().geodesic_distance(self._state().position, goal)
        return np.array([(start - cur) / max(start, 1e-8)], np.float32)

    def point_dist_to_goal(self, env_idx: int, pos) -> float:
        ep = self._env.current_episode
        return float(self._sim().geodesic_distance(
            list(map(float, pos)), ep.goals[0].position))

    def point_dists_to_goal(self, env_idx: int, positions) -> np.ndarray:
        """Batched oracle: one call for a whole candidate set (the
        DAgger teacher's per-step query, dagger_trainer.py:210-230)."""
        ep = self._env.current_episode
        goal = ep.goals[0].position
        return np.array([self._sim().geodesic_distance(
            list(map(float, p)), goal) for p in positions])

    def cand_real_pos(self, env_idx: int, angles, distances) -> np.ndarray:
        """State-preserving candidate simulation
        (environments.py:121-143)."""
        sim = self._sim()
        init = self._state()
        out = []
        for ang, dist in zip(angles, distances):
            q = init.rotation
            heading = heading_from_quaternion(
                np.array([q.x, q.y, q.z, q.w]))
            sim.set_agent_state(
                init.position,
                heading_to_quat((heading + ang) % (2 * math.pi)).tolist())
            for _ in range(int(dist // FORWARD_M)):
                if hasattr(sim, "step_without_obs"):
                    sim.step_without_obs(1)
                else:
                    sim.step(1)
            out.append(np.asarray(sim.get_agent_state().position))
        sim.set_agent_state(init.position, init.rotation)
        return np.stack(out)

    def ghost_dist_to_ref(self, env_idx: int, ghost_positions,
                          ref_path) -> int:
        """ndtw-expert subgoal with per-episode progress, replicating
        environments.py:157-192 exactly (incl. the run-relative indexing
        quirk and the origin-initialized previous subgoal) via the shared
        utils/trajectory.ndtw_subgoal_index — the same expert the
        geometric env runs, so DAgger/SPL labels agree across backends."""
        from etpnav_tpu_torch.utils.trajectory import ndtw_subgoal_index
        ep_id = self._env.current_episode.episode_id
        if getattr(self, "_ndtw_ep", None) != ep_id:
            self._ndtw_ep = ep_id
            self._ndtw_progress = 0
            self._ndtw_subgoal = np.zeros(3)   # environments.py:161
        ref = np.asarray(ref_path)
        pos = np.asarray(self._state().position)
        d = np.array([self._sim().geodesic_distance(pos, p) for p in ref])
        sub_idx, self._ndtw_progress = ndtw_subgoal_index(
            d <= 3.0, self._ndtw_progress)
        if sub_idx is not None:
            self._ndtw_subgoal = ref[sub_idx]
        sub_goal = self._ndtw_subgoal
        gd = [self._sim().geodesic_distance(list(map(float, g)),
                                            list(map(float, sub_goal)))
              for g in ghost_positions]
        return int(np.argmin(gd))


class HabitatVectorEnv:
    """construct_envs equivalent (env_utils.py:35-124): scene-sharded
    HabitatWorkerEnv pool with per-worker seeds and episode filters."""

    def __new__(cls, habitat_config, num_envs: int = 8,
                split: str = "train", episodes_allowed=None,
                scenes: Sequence[str] = None, seed: int = 0,
                threaded: bool = False, restart_on_crash: bool = False,
                episodes: Sequence[Episode] = None, shm_obs_spec=None):
        from etpnav_tpu_torch.env.habitat_adapter import shard_scenes
        from etpnav_tpu_torch.env.vector import ProcessVectorEnv

        if episodes is not None and episodes_allowed is not None:
            # filter BEFORE scene sharding so no worker ends up with an
            # empty allowed set (the worker-side filter would raise)
            allowed = set(map(str, episodes_allowed))
            episodes = [e for e in episodes
                        if str(e.episode_id) in allowed]
            if not episodes:
                raise ValueError("episodes_allowed matched no episode")
            episodes_allowed = None
        if episodes is not None and scenes is None:
            scenes = sorted({e.scene_id for e in episodes})
        shards = (shard_scenes(list(scenes), num_envs) if scenes
                  else [None] * num_envs)
        ep_shards = [None] * num_envs
        if episodes is not None:
            # each worker owns the episodes of its scene shard (scene-
            # sharded episode split, env_utils.py:89-96); workers sharing
            # a duplicated scene split its episodes round-robin instead
            # of double-reporting them
            by_scene = {}
            for e in episodes:
                by_scene.setdefault(e.scene_id, []).append(e)
            seen = {}
            ep_shards = []
            for shard in shards:
                mine = []
                for s in set(shard):
                    eps = by_scene.get(s, [])
                    if not eps:
                        continue
                    n_owners = sum(s in sh for sh in shards)
                    k = seen.get(s, 0)
                    seen[s] = k + 1
                    # more workers than episodes: duplicate rather than
                    # hand a worker an empty (invalid) dataset
                    mine.extend(eps[k::n_owners] or [eps[k % len(eps)]])
                ep_shards.append(mine or None)
        factories = [HabitatWorkerFactory(habitat_config, shards[i], split,
                                          seed + i, ep_shards[i],
                                          episodes_allowed)
                     for i in range(num_envs)]
        return ProcessVectorEnv(factories, threaded=threaded,
                                restart_on_crash=restart_on_crash,
                                shm_obs_spec=shm_obs_spec)


class HabitatWorkerFactory:
    """One worker's env, built in the worker process: its scene shard,
    split, seed and episodes. Plain pickle moves it to a forkserver or
    spawn worker (the habitat config travels with it)."""

    def __init__(self, habitat_config, content_scenes, split: str,
                 seed: int, episodes=None, episodes_allowed=None):
        self.habitat_config = habitat_config
        self.content_scenes = content_scenes
        self.split = split
        self.seed = seed
        self.episodes = episodes
        self.episodes_allowed = episodes_allowed

    def __call__(self):
        cfg_i = _config_for_worker(self.habitat_config, self.content_scenes,
                                   self.split, self.seed)
        return HabitatWorkerEnv(cfg_i, seed=self.seed,
                                episodes=self.episodes,
                                episodes_allowed=self.episodes_allowed)


def _config_for_worker(habitat_config, content_scenes, split: str,
                       seed: int):
    """Per-worker config: CONTENT_SCENES shard + SEED offset + SPLIT
    (env_utils.py:98-123). Duck-typed over yacs-style configs; returns
    the base config unchanged when it isn't mutable that way."""
    try:
        cfg = habitat_config.clone()
        cfg.defrost()
        if content_scenes is not None:
            cfg.DATASET.CONTENT_SCENES = list(content_scenes)
        cfg.DATASET.SPLIT = split
        cfg.SEED = seed
        cfg.freeze()
        return cfg
    except AttributeError:
        import logging
        logging.getLogger(__name__).warning(
            "habitat config %s is not yacs-mutable; scene sharding / "
            "split / seed overrides NOT applied", type(habitat_config))
        return habitat_config
