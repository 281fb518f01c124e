"""GeometricNavEnv: a synthetic continuous navigation world (the port's
own copy of `etpnav_tpu/env/geometric.py`, unchanged in behaviour: the
same seed gives the same episodes, observations and oracle answers).

Plays the role habitat-sim plays for the reference (SURVEY.md §4's
"sim-free fake env"): a deterministic, obstacle-bearing 2.5D world with the
exact control surface of VLNCEDaggerEnv (common/environments.py:340-518) —
15-degree turn quantization, 0.25 m forward micro-steps, collision
detection, the random-left/right "tryout" recovery sequences, teleport and
back-path control, stop semantics — plus procedural 12-view RGB-D
rendering so the full encoder stack has real pixels to chew on in CI
and benchmarks.

Geodesic distances are Euclidean in this world (no walls between free
cells); obstacles are circular pillars that block micro-stepping, which is
enough to exercise the tryout controller.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from etpnav_tpu_torch.env.protocol import Episode, StepResult

TURN_DEG = 15.0            # habitat TURN_LEFT actuation
FORWARD_M = 0.25           # habitat MOVE_FORWARD actuation
AGENT_RADIUS = 0.1

# tryout recovery turn sequences (environments.py:385-404): after a
# collision, turn 90deg left/right then probe (head_turn, tail_turn) pairs
TRYOUT_LEFT_FIRST = [(0, 270), (330, 300), (330, 330), (300, 30),
                     (330, 60), (330, 90)]
TRYOUT_RIGHT_FIRST = [(0, 90), (30, 60), (30, 30), (60, 330),
                      (30, 300), (30, 270)]


def heading_to_quat(heading: float) -> np.ndarray:
    """(x,y,z,w) quaternion for a rotation of `heading` about +y such that
    heading_from_quaternion() round-trips."""
    return np.array([0.0, math.sin(heading / 2.0), 0.0,
                     math.cos(heading / 2.0)])


class _World:
    """Deterministic per-scene world: circular obstacles on a plane."""

    def __init__(self, scene_seed: int, num_obstacles: int = 40,
                 extent: float = 20.0, radius: float = 0.35):
        g = np.random.default_rng(scene_seed)
        self.obstacles = g.uniform(-extent, extent, (num_obstacles, 2))
        self.radius = radius
        self.extent = extent

    def blocked(self, xz: np.ndarray) -> bool:
        if np.abs(xz).max() > self.extent + 5.0:
            return True
        d = np.linalg.norm(self.obstacles - xz[None], axis=1)
        return bool((d < self.radius + AGENT_RADIUS).any())


class GeometricNavEnv:
    """Batched synthetic env implementing the VectorNavEnv protocol."""

    def __init__(self, num_envs: int, *, seed: int = 0, vocab_size: int = 512,
                 max_instr_len: int = 16, image_size: int = 224,
                 depth_size: int = 128, episodes_per_env: int = 1000,
                 num_views: int = 12, pad_id: int = 0,
                 episodes: Optional[List[Episode]] = None):
        self._num_total = num_envs
        self.seed = seed
        self.vocab_size = vocab_size
        self.max_instr_len = max_instr_len
        self.image_size = image_size
        self.depth_size = depth_size
        self.num_views = num_views
        self.pad_id = pad_id
        self._episode_seeds = [seed * 10_000 + i for i in range(num_envs)]
        self._episode_counter = [0] * num_envs
        self._fixed_episodes = episodes
        self._rng = np.random.default_rng(seed + 777)

        self._worlds: List[_World] = [None] * num_envs
        self._episodes: List[Episode] = [None] * num_envs
        self._pos = np.zeros((num_envs, 3))
        self._heading = np.zeros((num_envs,))
        self._paused: List[int] = []
        self._live = list(range(num_envs))
        self._collisions = np.zeros(num_envs, np.int64)
        self._steps_taken = np.zeros(num_envs, np.int64)
        self._positions_log: List[List[np.ndarray]] = [
            [] for _ in range(num_envs)]
        self._heading_log: List[List[float]] = [[] for _ in range(num_envs)]
        self._path_progress = [0] * num_envs
        self._ndtw_progress: Dict[int, int] = {}
        self._ndtw_subgoal: Dict[int, np.ndarray] = {}
        self._detour_dir: Dict[int, int] = {}

    # ------------------------------------------------------------------ mgmt

    @property
    def num_envs(self) -> int:
        return len(self._live)

    def pause_at(self, idx: int):
        self._live.pop(idx)

    def resume_all(self):
        self._live = list(range(self._num_total))

    def current_episodes(self) -> List[Episode]:
        return [self._episodes[g] for g in self._live]

    # ------------------------------------------------------------- episodes

    def _make_episode(self, env_i: int) -> Episode:
        if self._fixed_episodes is not None:
            ep = self._fixed_episodes[
                self._episode_counter[env_i] % len(self._fixed_episodes)]
            self._episode_counter[env_i] += 1
            return ep
        eseed = (self._episode_seeds[env_i]
                 + self._episode_counter[env_i] * 131)
        self._episode_counter[env_i] += 1
        g = np.random.default_rng(eseed)
        start = np.array([g.uniform(-3, 3), 0.0, g.uniform(-3, 3)])
        # ground-truth path: a few segments of 1.5-3m
        path = [start]
        heading = g.uniform(0, 2 * math.pi)
        for _ in range(g.integers(3, 7)):
            heading += g.uniform(-1.0, 1.0)
            step = g.uniform(1.5, 3.0)
            nxt = path[-1] + np.array(
                [-step * math.sin(heading), 0.0, -step * math.cos(heading)])
            path.append(nxt)
        tokens = self._encode_instruction(path)
        return Episode(
            episode_id=str(eseed), scene_id=f"scene{eseed % 7}",
            instruction_tokens=tokens,
            instruction_text=f"synthetic instruction {eseed}",
            start_position=start, start_heading=float(g.uniform(0, 2*math.pi)),
            goal_position=path[-1],
            reference_path=[p.copy() for p in path],
            instruction_id=eseed,
        )

    def _encode_instruction(self, path) -> np.ndarray:
        """A learnable synthetic 'language': the gt path rendered as a
        token sequence of (direction, distance) pairs.

        Token map: 2=[CLS], 3=[SEP], 10+d = absolute direction sector
        d in [0,12), 30+q = segment length quantized to 0.5 m buckets.
        Together with the compass cue in the rendered views this makes the
        synthetic task genuinely instruction-conditional (unlike random
        tokens), so end-to-end IL can be validated without habitat."""
        tokens = np.full(self.max_instr_len, self.pad_id, np.int64)
        out = [2]
        for a, b in zip(path, path[1:]):
            d = b - a
            heading = math.atan2(-d[0], -d[2]) % (2 * math.pi)
            sector = int(round(heading / (2 * math.pi / 12))) % 12
            q = min(int(np.linalg.norm(d) / 0.5), 15)
            out.extend((10 + sector, 30 + q))
        out.append(3)
        n = min(len(out), self.max_instr_len)
        tokens[:n] = out[:n]
        return tokens

    def reset(self) -> List[Dict[str, np.ndarray]]:
        obs = []
        for g in self._live:
            ep = self._make_episode(g)
            self._episodes[g] = ep
            # deterministic scene hash (python hash() is process-salted)
            import zlib
            world = _World(zlib.crc32(ep.scene_id.encode()) % (2**31))
            # carve a corridor along the reference path so ground-truth
            # trajectories are navigable by construction (as in real data);
            # off-path obstacles remain to exercise collision/tryout
            world.obstacles = self._carve_corridor(
                world.obstacles, ep.reference_path,
                world.radius + AGENT_RADIUS + FORWARD_M)
            self._worlds[g] = world
            self._pos[g] = ep.start_position
            self._heading[g] = ep.start_heading
            self._collisions[g] = 0
            self._steps_taken[g] = 0
            self._positions_log[g] = [self._pos[g].copy()]
            self._heading_log[g] = [float(self._heading[g])]
            self._path_progress[g] = 0
            self._ndtw_progress.pop(g, None)
            self._ndtw_subgoal.pop(g, None)
            self._detour_dir.pop(g, None)
            obs.append(self._observation(g))
        return obs

    @staticmethod
    def _carve_corridor(obstacles: np.ndarray, path, clearance: float
                        ) -> np.ndarray:
        """Remove obstacles within `clearance` of the path polyline."""
        if len(path) < 2 or len(obstacles) == 0:
            return obstacles
        keep = np.ones(len(obstacles), bool)
        for a, b in zip(path, path[1:]):
            a2, b2 = a[[0, 2]], b[[0, 2]]
            seg = b2 - a2
            L2 = max(float(seg @ seg), 1e-12)
            t = np.clip(((obstacles - a2) @ seg) / L2, 0.0, 1.0)
            closest = a2 + t[:, None] * seg
            d = np.linalg.norm(obstacles - closest, axis=1)
            keep &= d > clearance
        return obstacles[keep]

    # ------------------------------------------------------------ rendering

    def _observation(self, g: int) -> Dict[str, np.ndarray]:
        """12-view RGB-D panorama + instruction tokens.

        The pixels carry learnable structure, not just texture:
        - a compass cue: each view's green channel encodes the *absolute*
          world heading that view faces (so the agent can ground the
          instruction's absolute direction tokens),
        - a goal beacon: the red channel brightens when the goal is within
          5 m and inside the view sector (grounds the stop decision),
        - depth encodes distance to the nearest obstacle in the sector.
        """
        ep = self._episodes[g]
        pos = self._pos[g]
        key = (int(pos[0] * 7.3) * 31 + int(pos[2] * 7.3)) % (2**16)
        rgb = np.empty((self.num_views, self.image_size, self.image_size, 3),
                       np.uint8)
        dep = np.empty((self.num_views, self.depth_size, self.depth_size, 1),
                       np.float32)
        lin = np.linspace(0, 1, self.image_size, dtype=np.float32)
        lin_d = np.linspace(0, 1, self.depth_size, dtype=np.float32)
        gvec = ep.goal_position - pos
        goal_dist = math.hypot(gvec[0], gvec[2])
        goal_head = math.atan2(-gvec[0], -gvec[2]) % (2 * math.pi)
        world = self._worlds[g]
        for v in range(self.num_views):
            # view v faces heading + v * 30deg (counter-clockwise)
            view_head = (self._heading[g] + v * 2 * math.pi
                         / self.num_views) % (2 * math.pi)
            compass = 0.5 + 0.5 * math.cos(view_head)
            compass2 = 0.5 + 0.5 * math.sin(view_head)
            ang_to_goal = abs((view_head - goal_head + math.pi)
                              % (2 * math.pi) - math.pi)
            beacon = max(0.0, 1.0 - goal_dist / 5.0) \
                if ang_to_goal < math.pi / 6 else 0.0
            phase = (key + v * 997) % 251 / 251.0
            tex = np.add.outer(lin, lin * (1 + phase)) / 2.0   # [0,1]
            rgb[v] = np.stack([
                np.clip(80 * tex + 175 * beacon, 0, 255).astype(np.uint8),
                np.clip(60 * tex + 195 * compass, 0, 255).astype(np.uint8),
                np.clip(60 * tex + 195 * compass2, 0, 255).astype(np.uint8),
            ], -1)
            # nearest obstacle distance in this sector (crude raycast)
            ray = np.array([-math.sin(view_head), -math.cos(view_head)])
            rel = world.obstacles - pos[[0, 2]][None]
            along = rel @ ray
            perp = np.abs(rel[:, 0] * ray[1] - rel[:, 1] * ray[0])
            hits = along[(along > 0) & (perp < world.radius + 0.3)]
            obst_d = float(hits.min()) if hits.size else 10.0
            dmap = np.clip(np.add.outer(lin_d * 0.2, lin_d * 0.2)
                           + obst_d / 10.0, 0, 1)
            dep[v] = dmap[..., None].astype(np.float32)
        return {
            "rgb": rgb, "depth": dep,
            "instruction": self._episodes[g].instruction_tokens.copy(),
        }

    # ---------------------------------------------------------- micro-steps

    def _forward_once(self, g: int) -> bool:
        """One 0.25 m forward micro-step. Returns True if collided
        (movement blocked)."""
        h = self._heading[g]
        delta = np.array([-FORWARD_M * math.sin(h), 0.0,
                          -FORWARD_M * math.cos(h)])
        nxt = self._pos[g] + delta
        self._steps_taken[g] += 1
        if self._worlds[g].blocked(nxt[[0, 2]]):
            self._collisions[g] += 1
            return True
        self._pos[g] = nxt
        self._log_pose(g)
        return False

    def _turn(self, g: int, ang_rad: float):
        """Quantized turn (environments.py:340-358): round to 15deg units,
        fold to (-180, 180], apply as one rotation (micro-turns have no
        collision in this world, so they compose)."""
        deg = round(math.degrees(ang_rad) / TURN_DEG) * TURN_DEG
        if 180 < deg <= 360:
            deg -= 360
        self._heading[g] = (self._heading[g] + math.radians(deg)) \
            % (2 * math.pi)
        self._steps_taken[g] += abs(int(deg // TURN_DEG))
        self._log_pose(g)

    def _log_pose(self, g: int):
        self._positions_log[g].append(self._pos[g].copy())
        self._heading_log[g].append(float(self._heading[g]))

    def _rel_angle_dist(self, g: int, target: np.ndarray):
        d = target - self._pos[g]
        dist = math.hypot(d[0], d[2])
        ang_world = math.atan2(-d[0], -d[2])
        rel = (ang_world - self._heading[g]) % (2 * math.pi)
        return rel, dist

    def _single_step_control(self, g: int, target: np.ndarray,
                             tryout: bool):
        """Turn-then-forward with tryout recovery
        (environments.py:363-421)."""
        rel, dist = self._rel_angle_dist(g, target)
        self._turn(g, rel)
        ksteps = int(dist // FORWARD_M)
        done_steps = 0
        collided = False
        for _ in range(ksteps):
            if self._forward_once(g):
                collided = True
                break
            done_steps += 1
        remaining = ksteps - done_steps
        if tryout and collided and remaining > 0:
            try_left = bool(self._rng.integers(0, 2))
            self._turn(g, math.radians(90 if try_left else 270))
            seqs = TRYOUT_LEFT_FIRST if try_left else TRYOUT_RIGHT_FIRST
            for head, tail in seqs:
                self._turn(g, math.radians(head))
                before = self._pos[g].copy()
                self._forward_once(g)
                if not np.allclose(before, self._pos[g]):
                    self._turn(g, math.radians(tail))
                    for _ in range(remaining):
                        if self._forward_once(g):
                            break
                    break

    def _teleport(self, g: int, pos: np.ndarray):
        self._pos[g] = np.asarray(pos, float).copy()
        self._heading[g] = 0.0
        self._log_pose(g)

    # --------------------------------------------------------------- actions

    def step(self, actions: Sequence[dict]) -> List[StepResult]:
        """act 4: (teleport|control) to front node then control to ghost;
        act 0: return/stop (environments.py:436-480)."""
        results = []
        for li, action in enumerate(actions):
            g = self._live[li]
            act = action["act"]
            if act == 4:
                if action.get("back_path") is None:
                    self._teleport(g, action["front_pos"])
                else:
                    for _vp, vp_pos in action["back_path"]:
                        self._single_step_control(g, np.asarray(vp_pos),
                                                  action.get("tryout", True))
                self._single_step_control(
                    g, np.asarray(action["ghost_pos"]),
                    action.get("tryout", True))
                done = False
            elif act == 0:
                if action.get("back_path") is None:
                    self._teleport(g, action["stop_pos"])
                else:
                    for _vp, vp_pos in action["back_path"]:
                        self._single_step_control(g, np.asarray(vp_pos),
                                                  action.get("tryout", True))
                done = True
            else:
                raise NotImplementedError(act)
            info = self._info(g) if done else {}
            results.append(StepResult(self._observation(g), done, info))
        return results

    # ---- low-level discrete API (legacy CMA/DAgger path,
    # habitat STOP/MOVE_FORWARD/TURN_LEFT/TURN_RIGHT) ----

    LOW_STOP, LOW_FWD, LOW_LEFT, LOW_RIGHT = 0, 1, 2, 3

    def step_low_level(self, actions: Sequence[int]) -> List[StepResult]:
        results = []
        for li, a in enumerate(actions):
            g = self._live[li]
            done = False
            if a == self.LOW_STOP:
                done = True
            elif a == self.LOW_FWD:
                self._forward_once(g)
            elif a == self.LOW_LEFT:
                self._turn(g, math.radians(TURN_DEG))
            elif a == self.LOW_RIGHT:
                self._turn(g, math.radians(-TURN_DEG))
            else:
                raise NotImplementedError(a)
            info = self._info(g) if done else {}
            results.append(StepResult(self._observation(g), done, info))
        return results

    def shortest_path_action(self, env_idx: int,
                             goal_radius: float = 0.5) -> int:
        """Shortest-path-follower teacher for the low-level action space
        (the reference's ShortestPathSensor oracle,
        habitat_extensions/sensors.py:70-113). Tracks per-episode path
        progress and steers toward the next unreached reference point."""
        g = self._live[env_idx]
        ep = self._episodes[g]
        pos = self._pos[g]
        if np.linalg.norm(ep.goal_position - pos) < goal_radius * 2:
            return self.LOW_STOP
        ref = ep.reference_path
        prog = self._path_progress[g]
        while (prog < len(ref) - 1
               and np.linalg.norm(ref[prog] - pos) < goal_radius):
            prog += 1
        self._path_progress[g] = prog
        target = ref[prog]
        rel, _ = self._rel_angle_dist(g, np.asarray(target))
        if rel > math.pi:
            rel -= 2 * math.pi

        def fwd_blocked(heading: float) -> bool:
            nxt = self._pos[g] + np.array([-FORWARD_M * math.sin(heading),
                                           0.0,
                                           -FORWARD_M * math.cos(heading)])
            return self._worlds[g].blocked(nxt[[0, 2]])

        h = self._heading[g]
        step = math.radians(TURN_DEG)
        detour = self._detour_dir.get(g, 0)
        if detour:
            # committed obstacle detour: advance the moment the forward
            # cell clears, else KEEP rotating the same way. Without the
            # commitment, the rel-based turn below immediately undoes the
            # sidestep and the teacher livelocks LEFT/RIGHT against an
            # off-corridor pillar until the step cap.
            if not fwd_blocked(h):
                self._detour_dir.pop(g, None)
                return self.LOW_FWD
            return self.LOW_LEFT if detour > 0 else self.LOW_RIGHT
        if abs(rel) <= step:
            if not fwd_blocked(h):
                return self.LOW_FWD
            # pick the detour side whose next heading clears first
            d = 1 if not fwd_blocked(h + step) else \
                (-1 if not fwd_blocked(h - step) else 1)
            self._detour_dir[g] = d
            return self.LOW_LEFT if d > 0 else self.LOW_RIGHT
        return self.LOW_LEFT if rel > 0 else self.LOW_RIGHT

    def _info(self, g: int) -> dict:
        ep = self._episodes[g]
        positions = np.stack(self._positions_log[g])
        dists = np.array([self._geodesic(p, ep.goal_position)
                          for p in positions])
        return {
            "position": {"position": positions, "distance": dists},
            "position_infer": {
                "position": [list(map(float, p))
                             for p in self._positions_log[g]],
                "heading": self._heading_log[g],
            },
            "steps_taken": int(self._steps_taken[g]),
            "collisions": {"count": int(self._collisions[g])},
        }

    # --------------------------------------------------------------- oracles

    @staticmethod
    def _geodesic(a: np.ndarray, b: np.ndarray) -> float:
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))

    def get_pos_ori(self):
        pos = np.stack([self._pos[g] for g in self._live])
        ori = np.stack([heading_to_quat(self._heading[g])
                        for g in self._live])
        return pos, ori

    def current_dist_to_goal(self) -> np.ndarray:
        return np.array([
            self._geodesic(self._pos[g], self._episodes[g].goal_position)
            for g in self._live])

    def progress(self) -> np.ndarray:
        """(distance_from_start - distance_to_goal) / distance_from_start
        per live env (VLNOracleProgressSensor, sensors.py:116-163)."""
        out = []
        for g in self._live:
            ep = self._episodes[g]
            start = self._geodesic(ep.start_position, ep.goal_position)
            cur = self._geodesic(self._pos[g], ep.goal_position)
            out.append((start - cur) / max(start, 1e-8))
        return np.asarray(out, np.float32)

    def point_dist_to_goal(self, env_idx: int, pos) -> float:
        g = self._live[env_idx]
        return self._geodesic(pos, self._episodes[g].goal_position)

    def point_dists_to_goal(self, env_idx: int, positions) -> np.ndarray:
        """Batched variant: one oracle call for a whole candidate set."""
        g = self._live[env_idx]
        goal = self._episodes[g].goal_position
        return np.array([self._geodesic(p, goal) for p in positions])

    def cand_real_pos(self, env_idx: int, angles, distances) -> np.ndarray:
        """Simulate each candidate: rotate to the (ccw) angle and forward
        k*0.25m with collisions, restoring state (environments.py:121-143)."""
        g = self._live[env_idx]
        save_pos, save_h = self._pos[g].copy(), self._heading[g]
        save_steps = self._steps_taken[g]
        save_coll = self._collisions[g]
        save_log = len(self._positions_log[g])
        out = []
        for ang, dist in zip(angles, distances):
            self._pos[g], self._heading[g] = save_pos.copy(), save_h
            self._heading[g] = (save_h + ang) % (2 * math.pi)
            for _ in range(int(dist // FORWARD_M)):
                if self._forward_once(g):
                    break
            out.append(self._pos[g].copy())
        # restore full agent state incl. measure logs (state-preserving
        # oracle, like the reference's set_agent_state round-trip)
        self._pos[g], self._heading[g] = save_pos, save_h
        self._steps_taken[g] = save_steps
        self._collisions[g] = save_coll
        self._positions_log[g] = self._positions_log[g][:save_log]
        self._heading_log[g] = self._heading_log[g][:save_log]
        return np.stack(out)

    def ghost_dist_to_ref(self, env_idx: int, ghost_positions,
                          ref_path) -> int:
        """ndtw-expert subgoal selection with per-episode progress
        (environments.py:157-192, replicated exactly incl. its
        run-relative indexing quirk — utils/trajectory.py
        ndtw_subgoal_index). Returns argmin-distance ghost index."""
        from etpnav_tpu_torch.utils.trajectory import ndtw_subgoal_index
        g = self._live[env_idx]
        ref = np.asarray(ref_path)
        d = np.array([self._geodesic(self._pos[g], p) for p in ref])
        progress = self._ndtw_progress.get(g, 0)
        # reference inits prev_sub_goal_pos to the origin
        # (environments.py:161); replicated for teacher parity
        sub_goal = self._ndtw_subgoal.get(g, np.zeros(3))
        sub_idx, progress = ndtw_subgoal_index(d <= 3.0, progress)
        if sub_idx is not None:
            sub_goal = ref[sub_idx]
            self._ndtw_progress[g] = progress
            self._ndtw_subgoal[g] = sub_goal
        gd = [self._geodesic(p, sub_goal) for p in ghost_positions]
        return int(np.argmin(gd))
