"""Episode datasets: R2R-CE / RxR-CE gz-JSON loaders (counterpart of
`etpnav_tpu/data/episodes.py`).

Capability target: habitat_extensions/task.py:38-242 — VLNCEDatasetV1 /
RxRVLNCEDatasetV1 with role/language filters and EPISODES_ALLOWED — plus
the scene-sharded episode iteration of env_utils. Emits the port's
Episode records directly (no habitat dependency).

Expected file layout (same as the reference's data/):
  R2R-CE:  {split}.json.gz            {"episodes": [...]}
  RxR-CE:  {split}_guide.json.gz      roles/languages per episode
"""

from __future__ import annotations

import gzip
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from etpnav_tpu_torch.env.protocol import Episode
from etpnav_tpu_torch.graph.geometry import heading_from_quaternion

RXR_ROLES = ("guide", "follower")


def _quat_heading(start_rotation) -> float:
    # habitat stores rotation as [x, y, z, w]
    return heading_from_quaternion(np.asarray(start_rotation, np.float64))


def load_r2r_episodes(path: str, *, max_instr_len: int = 80,
                      pad_id: int = 0,
                      episodes_allowed: Optional[Sequence[str]] = None
                      ) -> List[Episode]:
    """R2R-CE episodes with pre-tokenized instructions
    (VLNCEDatasetV1, task.py:48-133)."""
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    allowed = set(map(str, episodes_allowed)) if episodes_allowed else None
    out = []
    for ep in data["episodes"]:
        if allowed is not None and str(ep["episode_id"]) not in allowed:
            continue
        instr = ep["instruction"]
        tokens = np.full(max_instr_len, pad_id, np.int64)
        raw = instr.get("instruction_tokens", [])
        n = min(len(raw), max_instr_len)
        tokens[:n] = np.asarray(raw[:n], np.int64)
        out.append(Episode(
            episode_id=str(ep["episode_id"]),
            scene_id=ep["scene_id"],
            instruction_tokens=tokens,
            instruction_text=instr.get("instruction_text", ""),
            start_position=np.asarray(ep["start_position"], np.float64),
            start_heading=_quat_heading(ep["start_rotation"]),
            goal_position=np.asarray(ep["goals"][0]["position"],
                                     np.float64),
            reference_path=[np.asarray(p, np.float64)
                            for p in ep.get("reference_path", [])],
        ))
    return out


def load_rxr_episodes(path: str, *, roles: Sequence[str] = ("guide",),
                      languages: Sequence[str] = ("*",),
                      max_instr_len: int = 200, pad_id: int = 1,
                      episodes_allowed: Optional[Sequence[str]] = None,
                      tokenizer=None) -> List[Episode]:
    """RxR-CE episodes with role/language filtering
    (RxRVLNCEDatasetV1, task.py:135-242). Tokenization happens here if a
    tokenizer is provided (the reference ships token features separately).

    Roles select FILES, as in the reference (task.py:172-190: one
    ``{split}_{role}.json.gz`` per role): a ``{role}`` placeholder in
    `path` is expanded per requested role ("*" = all annotation roles).
    A role-less path loads the single file unchanged.
    """
    if "{role}" in path:
        role_list = RXR_ROLES if "*" in roles else tuple(roles)
        unknown = set(role_list) - set(RXR_ROLES)
        if unknown:
            raise ValueError(f"unknown RxR roles {sorted(unknown)}; "
                             f"annotation roles are {RXR_ROLES}")
        out: List[Episode] = []
        for role in role_list:
            out.extend(load_rxr_episodes(
                path.format(role=role), roles=(role,),
                languages=languages, max_instr_len=max_instr_len,
                pad_id=pad_id, episodes_allowed=episodes_allowed,
                tokenizer=tokenizer))
        return out
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    allowed = set(map(str, episodes_allowed)) if episodes_allowed else None
    lang_any = "*" in languages
    out = []
    for ep in data["episodes"]:
        if allowed is not None and str(ep["episode_id"]) not in allowed:
            continue
        instr = ep["instruction"]
        lang = instr.get("language", "")
        if not lang_any and not any(lang.startswith(l) for l in languages):
            continue
        text = instr.get("instruction_text", "")
        tokens = np.full(max_instr_len, pad_id, np.int64)
        if tokenizer is not None:
            ids = tokenizer(text, truncation=True,
                            max_length=max_instr_len)["input_ids"]
            tokens[:len(ids)] = ids
        elif "instruction_tokens" in instr:
            raw = instr["instruction_tokens"][:max_instr_len]
            tokens[:len(raw)] = raw
        iid = str(instr.get("instruction_id", "-1"))
        out.append(Episode(
            episode_id=str(ep["episode_id"]),
            scene_id=ep["scene_id"],
            instruction_tokens=tokens,
            instruction_text=text,
            start_position=np.asarray(ep["start_position"], np.float64),
            start_heading=_quat_heading(ep["start_rotation"]),
            goal_position=np.asarray(ep["goals"][0]["position"],
                                     np.float64),
            reference_path=[np.asarray(p, np.float64)
                            for p in ep.get("reference_path", [])],
            instruction_id=int(iid) if iid.lstrip("-").isdigit() else None,
        ))
    return out


def load_gt_paths(path: str) -> Dict[str, np.ndarray]:
    """{split}_gt.json.gz -> episode_id -> (N,3) gt locations (ndtw
    supervision, ss_trainer_ETP.py:443-449)."""
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    return {str(k): np.asarray(v["locations"], np.float64)
            for k, v in data.items()}


def fast_eval_subset(episodes: Sequence[Episode]) -> List[Episode]:
    """EVAL.fast_eval: every 5th episode (ss_trainer_ETP.py:569)."""
    return list(episodes)[::5]


def scenes_of(episodes: Sequence[Episode]) -> List[str]:
    return sorted({ep.scene_id for ep in episodes})


def shard_scenes(scenes: Sequence[str], num_workers: int
                 ) -> List[List[str]]:
    """Round-robin scene assignment (env_utils.py:89-96): sort scenes by
    name, deal them out so each worker gets a disjoint subset; workers
    beyond the scene count share duplicates."""
    scenes = sorted(scenes)
    if len(scenes) >= num_workers:
        return [scenes[i::num_workers] for i in range(num_workers)]
    return [[scenes[i % len(scenes)]] for i in range(num_workers)]


def shard_episodes_by_scene(episodes: Sequence[Episode],
                            num_shards: int) -> List[List[Episode]]:
    """Scene-disjoint episode shards for worker processes
    (env_utils.py:53-123)."""
    shards = shard_scenes(scenes_of(episodes), num_shards)
    by_scene: Dict[str, List[Episode]] = {}
    for ep in episodes:
        by_scene.setdefault(ep.scene_id, []).append(ep)
    return [[ep for s in shard for ep in by_scene.get(s, [])]
            for shard in shards]
