"""Checkpoint-folder evaluation loop (counterpart of
`etpnav_tpu/training/eval_loop.py`).

Capability target: BaseVLNCETrainer.eval's producer/consumer pattern
(common/base_il_trainer.py:774-889): poll a checkpoint directory, evaluate
each new checkpoint once (skip-if-evaluated guard,
ss_trainer_ETP.py:558-565), aggregate + persist results. The trainer is
the port's `FinetuneTrainer` (`load_checkpoint`, `evaluate`).
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Dict, Optional, Set


def checkpoint_index(path: str) -> int:
    m = re.search(r"iter(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def poll_checkpoint_folder(ckpt_dir: str, evaluated: Set[str]
                           ) -> Optional[str]:
    """Oldest not-yet-evaluated checkpoint, by iteration index
    (base_il_trainer.py:874-889 semantics); the temporary file of an
    unfinished save is skipped."""
    cands = sorted((p for p in glob.glob(os.path.join(ckpt_dir,
                                                      "ckpt_iter*"))
                    if ".tmp-" not in os.path.basename(p)),
                   key=checkpoint_index)
    for c in cands:
        if c not in evaluated:
            return c
    return None


def eval_checkpoint_loop(trainer, ckpt_dir: str, results_dir: str, *,
                         episode_count: int, split: str = "val_unseen",
                         poll_interval: float = 10.0,
                         max_wait: float = 0.0,
                         gt_paths=None) -> Dict[str, dict]:
    """Evaluate every checkpoint that appears in ckpt_dir. Returns
    {ckpt_path: stats}. max_wait==0 evaluates what exists and returns;
    >0 keeps polling (the reference polls forever)."""
    os.makedirs(results_dir, exist_ok=True)
    evaluated: Set[str] = set()
    results: Dict[str, dict] = {}
    deadline = time.time() + max_wait
    while True:
        ckpt = poll_checkpoint_folder(ckpt_dir, evaluated)
        if ckpt is None:
            if time.time() >= deadline:
                break
            time.sleep(poll_interval)
            continue
        idx = checkpoint_index(ckpt)
        out_file = os.path.join(results_dir,
                                f"stats_ckpt_{idx}_{split}.json")
        evaluated.add(ckpt)
        if os.path.exists(out_file):   # skip-if-evaluated guard
            with open(out_file) as f:
                results[ckpt] = json.load(f)
            continue
        trainer.load_checkpoint(ckpt)
        stats = trainer.evaluate(episode_count, gt_paths=gt_paths)
        with open(out_file, "w") as f:
            json.dump(stats, f, indent=2)
        results[ckpt] = stats
    return results
