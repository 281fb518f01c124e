"""Habitat-sim adapter: the production env behind VectorNavEnv
(counterpart of `etpnav_tpu/env/habitat_adapter.py`).

Capability target: the reference's habitat stack — Sim-v1 wrapper with
step_without_obs (habitat_extensions/habitat_simulator.py:62-93),
VLNCEDaggerEnv control/oracles (common/environments.py:44-518), and
construct_envs scene-sharded worker processes (common/env_utils.py:35-124).

habitat-sim is a host-side C++ dependency; everything here is
import-gated, and the runner falls back to GeometricNavEnv without it. The adapter maps the batched
VectorNavEnv protocol onto a pool of habitat processes, issuing oracle
queries in one batch per step instead of per-env round-trips.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def habitat_available() -> bool:
    try:
        import habitat            # noqa: F401
        import habitat_sim        # noqa: F401
        return True
    except ImportError:
        return False


def make_habitat_envs(cfg, num_envs: int = 8, split: str = "train",
                      episodes_allowed: Optional[List[str]] = None,
                      scenes: Optional[List[str]] = None,
                      task_config_path: Optional[str] = None,
                      seed: Optional[int] = None):
    """Build a scene-sharded habitat worker pool (env_utils.py:35-124):
    scenes split round-robin across workers, each worker filtered to its
    scene subset, seeds offset per worker.

    cfg is the framework ExperimentConfig; the habitat TASK config is
    built here via make_vlnce_task_config (12-camera rig injection +
    control quantization + dataset paths — the reference's _set_config
    surgery, ss_trainer_ETP.py:85-123) — workers must never see the
    ExperimentConfig. When cfg.paths.data_path is set, episodes are
    loaded habitat-free (data/episodes.py) and injected into the workers
    directly; otherwise habitat's own dataset registry is used and
    scenes default to its scene list (get_scenes_to_load,
    env_utils.py:66-75)."""
    if not habitat_available():
        raise RuntimeError(
            "habitat-sim is not installed; use GeometricNavEnv for "
            "simulation-free runs or install habitat-sim>=0.1.7")
    import habitat
    from etpnav_tpu_torch.env.habitat_config import (
        load_split_episodes,
        make_vlnce_task_config,
    )
    from etpnav_tpu_torch.env.habitat_worker import HabitatVectorEnv
    base = (habitat.get_config(task_config_path) if task_config_path
            else None)
    task_cfg = make_vlnce_task_config(cfg, split=split, base=base)
    episodes = None
    if cfg.paths.data_path:
        episodes = load_split_episodes(cfg, split, episodes_allowed)
        episodes_allowed = None          # already applied
    if episodes is None and scenes is None:
        try:
            dataset_cls = habitat.registry.get_dataset(
                task_cfg.DATASET.TYPE)
            scenes = dataset_cls.get_scenes_to_load(task_cfg.DATASET)
        except Exception:           # dataset without scene enumeration
            scenes = None
    shm_spec = None
    if getattr(cfg, "shm_observations", False):
        from etpnav_tpu_torch.env.shm_transport import ObsSpec
        s, d = cfg.clip.image_size, cfg.depth.input_size
        shm_spec = ObsSpec({
            "rgb": ((12, s, s, 3), np.uint8),
            "depth": ((12, d, d, 1), np.float32)})
    return HabitatVectorEnv(
        task_cfg, num_envs=num_envs, split=split,
        episodes_allowed=episodes_allowed, scenes=scenes,
        seed=cfg.seed if seed is None else seed,
        restart_on_crash=getattr(cfg, "restart_crashed_workers", False),
        episodes=episodes, shm_obs_spec=shm_spec)


def shard_scenes(scenes: List[str], num_workers: int) -> List[List[str]]:
    """Round-robin scene assignment (env_utils.py:89-96): sort scenes by
    name, deal them out so each worker gets a disjoint subset; workers
    beyond the scene count share duplicates."""
    scenes = sorted(scenes)
    if len(scenes) >= num_workers:
        shards = [scenes[i::num_workers] for i in range(num_workers)]
    else:
        shards = [[scenes[i % len(scenes)]] for i in range(num_workers)]
    return shards
