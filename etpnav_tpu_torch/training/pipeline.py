"""Pipelined rollout (counterpart of `etpnav_tpu/training/pipeline.py`):
overlap the simulators' stepping with the device's programs.

Within one env batch a step's action needs that step's logits, so the
overlap is across the batch: the envs are split into pools, each run by
its own `RolloutEngine` in a thread. While one pool waits on its worker
processes (the GIL is released in the pipe read), the other pool's
programs run on the device. The engines share one `Agent`, whose
programs run under `torch.inference_mode()` per call (thread-local), and
each keeps its own numpy and torch generators. The records concatenate
along the env axis for the learn step: the pools run independent
episodes, so this is one larger batch.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np

from etpnav_tpu_torch.training.rollout import RolloutEngine, RolloutRecord


def concat_records(records: List[Optional[RolloutRecord]]) -> RolloutRecord:
    records = [r for r in records if r is not None]
    return RolloutRecord(**{
        f.name: np.concatenate([getattr(r, f.name) for r in records], axis=0)
        for f in dataclasses.fields(RolloutRecord)})


class PipelinedRollout:
    """Runs N RolloutEngines (disjoint env pools) in threads."""

    def __init__(self, engines: List[RolloutEngine]):
        self.engines = engines

    def run(self, mode: str, sample_ratio: float = 0.0, gt_paths=None,
            stat_eps: Optional[dict] = None,
            path_eps: Optional[dict] = None,
            sample_actions: bool = False,
            video_dir=None) -> Optional[RolloutRecord]:
        results: List[Optional[RolloutRecord]] = [None] * len(self.engines)
        errors: List[Optional[BaseException]] = [None] * len(self.engines)
        # eval/infer share the dedup dicts; a dict write is atomic under
        # the GIL
        kwargs = dict(sample_ratio=sample_ratio, gt_paths=gt_paths,
                      stat_eps=stat_eps, path_eps=path_eps,
                      sample_actions=sample_actions, video_dir=video_dir)

        def worker(i):
            try:
                results[i] = self.engines[i].run(mode, **kwargs)
            except BaseException as e:   # noqa: BLE001 — re-raised below
                errors[i] = e

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(len(self.engines))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        if mode != "train":
            return None
        return concat_records(results)
