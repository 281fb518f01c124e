"""Host-side vectorized environment protocol (the port's own copy of
`etpnav_tpu/env/protocol.py`).

Capability target: the surface the reference trainer drives on
habitat.VectorEnv + VLNCEDaggerEnv (ss_trainer_ETP.py:256-306,758-773,979;
common/environments.py:44-518) — re-designed around *batched* oracle calls:
the reference issues one IPC round-trip per env per query
(envs.call_at, flagged in SURVEY.md §3.1); here every oracle is one
vectorized call returning arrays for all live envs.

Implementations:
- GeometricNavEnv (env/geometric.py): synthetic continuous world for CI and
  benchmarking, no habitat dependency. (The habitat adapter has not been
  ported yet.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence

import numpy as np


@dataclasses.dataclass
class Episode:
    episode_id: str
    scene_id: str
    instruction_tokens: np.ndarray      # (L,) int
    instruction_text: str
    start_position: np.ndarray          # (3,)
    start_heading: float
    goal_position: np.ndarray           # (3,)
    reference_path: List[np.ndarray]    # gt locations
    instruction_id: Optional[int] = None


@dataclasses.dataclass
class StepResult:
    observation: Dict[str, np.ndarray]
    done: bool
    info: Dict[str, Any]


class VectorNavEnv(Protocol):
    """Batched vectorized navigation environment."""

    @property
    def num_envs(self) -> int: ...

    def reset(self) -> List[Dict[str, np.ndarray]]: ...

    def step(self, actions: Sequence[dict]) -> List[StepResult]: ...

    def current_episodes(self) -> List[Episode]: ...

    def pause_at(self, idx: int) -> None: ...

    def resume_all(self) -> None: ...

    # ---- batched oracles (one call for all live envs) ----
    def get_pos_ori(self) -> tuple:
        """(positions (N,3), orientations xyzw (N,4))."""
        ...

    def current_dist_to_goal(self) -> np.ndarray:
        """(N,) geodesic distance to goal (environments.py:108-113)."""
        ...

    def point_dist_to_goal(self, env_idx: int, pos: np.ndarray) -> float:
        """geodesic distance from pos to env's goal
        (environments.py:115-119)."""
        ...

    def cand_real_pos(self, env_idx: int, angles: np.ndarray,
                      distances: np.ndarray) -> np.ndarray:
        """(K,3) world positions reached by executing each candidate
        (environments.py:121-143), batched per env."""
        ...

    def ghost_dist_to_ref(self, env_idx: int, ghost_positions: np.ndarray,
                          ref_path: np.ndarray) -> int:
        """Index of the ghost nearest the ndtw-progress subgoal
        (environments.py:157-192)."""
        ...
