"""Checkpoint save/load with `torch.save`, plus requeue-style resume
(counterpart of `etpnav_tpu/training/checkpoints.py`, which writes orbax
trees; the port does not read those — JAX parameters come in through
`models/convert.py`).

A checkpoint is one file holding the state dicts (parameters, optimizer
state) and the iteration, as the reference's save_checkpoint does
(ss_trainer_ETP.py:74-83). It is written to a temporary name and renamed,
so a preempted save never leaves a partial file under a checkpoint name.
A world of several ranks (`parallel/mesh.py`) keeps this one-process
format: the trainers gather the split tensors whole, global rank 0 writes
(`save_from_rank0`) and every rank re-splits what it loads.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Optional

import torch


def save_checkpoint(path: str, state: Any) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def save_from_rank0(path: str, state: Any) -> None:
    """`save_checkpoint` on global rank 0 only (every rank when no
    process group is active); every rank then waits for the write."""
    from etpnav_tpu_torch.parallel import mesh as meshlib
    if meshlib.is_writer():
        save_checkpoint(path, state)
    meshlib.barrier()


def load_checkpoint(path: str, map_location=None) -> Any:
    """The saved state; only tensors and plain containers are unpickled."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def latest_checkpoint(ckpt_dir: str, pattern: str = "ckpt_iter*"
                      ) -> Optional[str]:
    """Newest checkpoint by iteration number then mtime (requeue resume,
    ss_trainer_ETP.py:216-225); temporary files of an unfinished save are
    skipped."""
    cands = [p for p in glob.glob(os.path.join(ckpt_dir, pattern))
             if ".tmp-" not in os.path.basename(p)]
    if not cands:
        return None

    def key(p):
        m = re.search(r"(?:iter|step_?)(\d+)", os.path.basename(p))
        return (int(m.group(1)) if m else -1, os.path.getmtime(p))
    return max(cands, key=key)
