"""Habitat TASK-config surgery + episode injection (counterpart of
`etpnav_tpu/env/habitat_config.py`).

Capability target: the reference's habitat-side glue that round 1 left
out:
- 12-camera panorama rig injection: the reference clones the base
  RGB/DEPTH sensor config for 11 extra yaw orientations and registers
  them on the simulator agent (ss_trainer_ETP.py:97-113,
  common/utils.py:62-67 get_camera_orientations12);
- dataset path / split wiring (run_r2r/r2r_vlnce.yaml DATASET section,
  habitat_extensions/config/default.py:120-134);
- episode injection: the reference registers `VLN-CE-v1` /
  `RxR-VLN-CE-v1` dataset types into habitat's registry via import side
  effects (habitat_extensions/task.py:48,135, __init__.py:1-4). This
  build loads episodes habitat-free (data/episodes.py) and hands a
  prebuilt dataset object to habitat.Env instead — no registry import
  magic needed.

Everything here is duck-typed over yacs-style configs (attribute access,
defrost/freeze when present) so it runs against mock habitat objects in
CI and against real habitat-lab v0.1.7 configs in production.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

from etpnav_tpu_torch.env.protocol import Episode

NUM_VIEWS = 12


def _defrost(cfg):
    if hasattr(cfg, "defrost"):
        cfg.defrost()


def _freeze(cfg):
    if hasattr(cfg, "freeze"):
        cfg.freeze()


def inject_camera_rig(task_config, *, rgb_size: Optional[int] = None,
                      depth_size: Optional[int] = None):
    """Register the 12-camera panorama rig on a habitat TASK config.

    Mirrors ss_trainer_ETP.py:97-113: for each of RGB/DEPTH, deep-copy
    the base sensor config 11 times with yaw orientations at 30-degree
    counter-clockwise increments (utils/trajectory.py
    camera_orientations_12), uuids ``rgb_1``..``rgb_11`` /
    ``depth_1``..``depth_11`` (view 0 keeps the base ``rgb``/``depth``
    uuid), and append the new sensor names to ``AGENT_0.SENSORS``.

    Unlike the reference, views render directly at the model input size
    (rgb_size/depth_size) instead of rendering large and resizing
    through obs transformers — one less host-side resample per frame.
    Mutates and returns task_config.
    """
    from etpnav_tpu_torch.utils.trajectory import camera_orientations_12

    _defrost(task_config)
    sim = task_config.SIMULATOR
    orients = camera_orientations_12()
    for stype, size in (("RGB", rgb_size), ("DEPTH", depth_size)):
        base = getattr(sim, f"{stype}_SENSOR")
        if size is not None:
            base.WIDTH = size
            base.HEIGHT = size
        for key, orient in orients.items():
            if key == "":
                continue                      # view 0 = the base sensor
            cam = copy.deepcopy(base)
            cam.ORIENTATION = list(orient)
            cam.UUID = f"{stype.lower()}{key}"
            name = f"{stype}{key.upper() if key else ''}"
            setattr(sim, name, cam)
            if name not in sim.AGENT_0.SENSORS:
                sim.AGENT_0.SENSORS.append(name)
    _freeze(task_config)
    return task_config


def apply_dataset_paths(task_config, paths, task_type: str, split: str):
    """Wire the DATASET subtree from DataPathsConfig (reference
    run_r2r/r2r_vlnce.yaml DATASET + habitat_extensions/config/
    default.py:120-134). Only touches keys that exist on the config
    (duck-typed across habitat versions). Mutates and returns it."""
    _defrost(task_config)
    ds = task_config.DATASET
    ds.TYPE = "VLN-CE-v1" if task_type == "r2r" else "RxR-VLN-CE-v1"
    ds.SPLIT = split
    if paths.data_path:
        ds.DATA_PATH = paths.data_path
    if paths.scenes_dir:
        ds.SCENES_DIR = paths.scenes_dir
    for attr, val in (("ROLES", list(paths.roles)),
                      ("LANGUAGES", list(paths.languages))):
        if hasattr(ds, attr):
            setattr(ds, attr, val)
    if paths.gt_path:
        task = task_config.TASK
        for m in ("NDTW", "SDTW"):
            if hasattr(task, m) and hasattr(getattr(task, m), "GT_PATH"):
                getattr(task, m).GT_PATH = paths.gt_path
                getattr(task, m).SPLIT = split
    _freeze(task_config)
    return task_config


def make_vlnce_task_config(cfg, split: str = "train", base=None):
    """Build the habitat TASK config for a VLN-CE run: base config (from
    cfg.paths.task_config or habitat defaults), control quantization
    (0.25 m forward / 15-degree turns, r2r_vlnce.yaml SIMULATOR), the
    12-camera rig at model input sizes, and dataset paths.

    ``base`` overrides the habitat.get_config call (used by tests with a
    mock config object). The runner's env constructors call this one
    function; after it, the worker's _pack_obs finds 12 distinct
    per-view sensors.
    """
    if base is None:
        import habitat
        base = (habitat.get_config(cfg.paths.task_config)
                if cfg.paths.task_config else habitat.get_config())
    _defrost(base)
    sim = base.SIMULATOR
    sim.FORWARD_STEP_SIZE = 0.25
    sim.TURN_ANGLE = 15
    if hasattr(sim, "HABITAT_SIM_V0"):
        sim.HABITAT_SIM_V0.ALLOW_SLIDING = True
    inject_camera_rig(base, rgb_size=cfg.clip.image_size,
                      depth_size=cfg.depth.input_size)
    apply_dataset_paths(base, cfg.paths, cfg.task_type, split)
    _freeze(base)
    return base


# ---------------------------------------------------------------------------
# episode injection
# ---------------------------------------------------------------------------

class _Instruction:
    def __init__(self, text: str, tokens):
        self.instruction_text = text
        self.instruction_tokens = list(map(int, tokens))


class _Goal:
    def __init__(self, position):
        self.position = [float(x) for x in position]
        self.radius = 3.0


class _HabitatEpisode:
    """Minimal habitat-episode record (attribute surface of
    habitat_extensions/task.py:28-46 VLNExtendedEpisode). habitat's VLN
    task and our HabitatWorkerEnv only read attributes, so a plain
    object travels across habitat versions better than subclassing
    habitat.core.dataset.Episode."""

    def __init__(self, ep: Episode):
        from etpnav_tpu_torch.env.geometric import heading_to_quat
        self.episode_id = ep.episode_id
        self.scene_id = ep.scene_id
        self.start_position = [float(x) for x in ep.start_position]
        self.start_rotation = [float(x) for x in
                               heading_to_quat(ep.start_heading)]
        self.goals = [_Goal(ep.goal_position)]
        self.instruction = _Instruction(ep.instruction_text,
                                        ep.instruction_tokens)
        self.reference_path = [[float(x) for x in p]
                               for p in ep.reference_path]
        self.trajectory_id = ep.instruction_id
        self.info = {}


class EpisodeDataset:
    """Dataset object handed to habitat.Env(config, dataset=...):
    replaces the reference's registry-side dataset classes
    (task.py:48,135) with direct injection from data/episodes.py
    records. Exposes the small surface habitat.Env actually uses."""

    def __init__(self, episodes: Sequence[Episode]):
        self.episodes = [_HabitatEpisode(e) for e in episodes]

    @property
    def scene_ids(self) -> List[str]:
        return sorted({e.scene_id for e in self.episodes})

    def filter_episodes(self, filter_fn) -> "EpisodeDataset":
        out = EpisodeDataset([])
        out.episodes = [e for e in self.episodes if filter_fn(e)]
        return out

    def get_episode_iterator(self, *args, **kwargs):
        """Honors the ITERATOR_OPTIONS habitat.Env forwards here:
        cycle (default True), shuffle (default True — the reference
        trains with habitat's shuffling EpisodeIterator), seed, and
        group_by_scene (shuffle scene order but keep each scene's
        episodes contiguous, minimizing scene loads). Other options
        (max_scene_repeat_*) are scene-cache tuning and are ignored."""
        import random

        def opt(name, default):
            v = kwargs.get(name, default)
            return default if v is None else v

        cycle = bool(opt("cycle", True))
        shuffle = bool(opt("shuffle", True))
        group = bool(opt("group_by_scene", True))
        rng = random.Random(kwargs.get("seed"))

        def epoch():
            eps = list(self.episodes)
            if shuffle and group:
                by_scene = {}
                for e in eps:
                    by_scene.setdefault(e.scene_id, []).append(e)
                scenes = list(by_scene)
                rng.shuffle(scenes)
                eps = []
                for s in scenes:
                    rng.shuffle(by_scene[s])
                    eps.extend(by_scene[s])
            elif shuffle:
                rng.shuffle(eps)
            return eps

        def gen():
            while True:
                yield from epoch()
                if not cycle:
                    return

        return gen()


def episodes_to_habitat_dataset(episodes: Sequence[Episode]
                                ) -> EpisodeDataset:
    if not episodes:
        raise ValueError("no episodes to inject — an empty dataset would "
                         "make habitat.Env fail opaquely at reset")
    return EpisodeDataset(episodes)


def load_split_episodes(cfg, split: str,
                        episodes_allowed: Optional[Sequence[str]] = None
                        ) -> List[Episode]:
    """Load the configured split via data/episodes.py ({split}
    interpolation like the reference DATA_PATH)."""
    from etpnav_tpu_torch.data import episodes as ep_lib
    # replace (not str.format): RxR templates also carry a {role}
    # placeholder that load_rxr_episodes expands per role
    path = cfg.paths.data_path.replace("{split}", split)
    if cfg.task_type == "rxr":
        return ep_lib.load_rxr_episodes(
            path, roles=cfg.paths.roles, languages=cfg.paths.languages,
            max_instr_len=cfg.il.max_text_len,
            pad_id=cfg.planner.pad_token_id,
            episodes_allowed=episodes_allowed)
    return ep_lib.load_r2r_episodes(
        path, max_instr_len=cfg.il.max_text_len,
        pad_id=cfg.planner.pad_token_id,
        episodes_allowed=episodes_allowed)
