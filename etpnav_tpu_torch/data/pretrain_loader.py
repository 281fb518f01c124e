"""Pretraining input from record files through `torch.utils.data`
(counterpart of `etpnav_tpu/data/grain_loader.py`).

Capability target: the reference's loader stack
(pretrain_src/pretrain_src/data/loader.py:18-164) — MetaLoader multinomial
task mixing, per-task datasets, DataLoader workers.

- One record file is written **per task**, since the reference's task
  datasets sample different end-viewpoint mixtures (tasks.py:163,
  286-293,378): SAP records bake the pos/neg end viewpoint and the action
  label, MRC records the per-token soft labels and which tokens are
  views, OG records the object label.
- Randomness that must differ per epoch stays at load time: MLM token
  masking and MRC view masking draw from a numpy generator per DataLoader
  worker, seeded from (seed, worker id).
- `MetaLoader` draws the task of each step from a shared-seed generator
  (as `GrainMetaLoader` does), so processes with the same seed agree on
  the task sequence without a collective.

The record format is the port's own, since neither grain nor ArrayRecord
is a dependency here: each record is a `np.savez` of the fixed-shape
arrays `PretrainSampler._assemble` produces, and a file is

    b"ETPREC1\\0" | uint64 count | uint64 offsets[count + 1] | records

with the offsets relative to the first record, so a record is read with
one seek. A collated batch is a dict of numpy arrays with the keys,
dtypes and shapes of `PretrainSampler.sample_batch`.
"""

from __future__ import annotations

import io
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from etpnav_tpu_torch.data.pretrain_data import (
    PretrainSampler,
    PretrainShapes,
    mask_tokens,
    mrc_token_info,
    og_slot_label,
    sample_mrc_mask,
)

MAGIC = b"ETPREC1\0"


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def encode_record(sample: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **sample)
    return buf.getvalue()


def decode_record(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def write_records(path: str, records: Sequence[bytes]) -> str:
    offsets = np.zeros(len(records) + 1, np.uint64)
    offsets[1:] = np.cumsum([len(r) for r in records], dtype=np.uint64)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(records)))
        f.write(offsets.astype("<u8").tobytes())
        for r in records:
            f.write(r)
    return path


def write_task_records(path: str, sampler: PretrainSampler, task: str,
                       num_records: int) -> str:
    """`num_records` assembled samples of one proxy task from `sampler`
    (its draws in `sample_batch`'s order) into the record file `path`."""
    sh = sampler.sh
    if task == "og" and sh.num_objs <= 0:
        raise ValueError("og records require num_objs > 0")
    end_vp_type = "pos" if task in ("mrc", "og") else None
    records = []
    for _ in range(num_records):
        w, traj = sampler._sample_traj(end_vp_type)
        sample, aux = sampler._assemble(w, traj)
        if task == "mrc":
            is_view, probs = mrc_token_info(sh, sample, aux)
            sample["mrc_is_view"] = is_view
            sample["vp_view_probs"] = probs
        elif task == "og":
            sample["obj_labels"] = np.int64(og_slot_label(sh, aux))
        records.append(encode_record(sample))
    return write_records(path, records)


class RecordFile:
    """Random access to the records of one file (opened per process)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path} is not a pretraining record file")
            (n,) = struct.unpack("<Q", f.read(8))
            self.offsets = np.frombuffer(f.read(8 * (n + 1)), "<u8")
        self.base = len(MAGIC) + 8 + 8 * (len(self.offsets))
        self._f = None

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> bytes:
        if self._f is None:
            self._f = open(self.path, "rb")
        start, end = int(self.offsets[i]), int(self.offsets[i + 1])
        self._f.seek(self.base + start)
        return self._f.read(end - start)

    def __getstate__(self):
        # a worker process opens its own handle
        return {**self.__dict__, "_f": None}


# ---------------------------------------------------------------------------
# datasets and loaders
# ---------------------------------------------------------------------------

def worker_rng(seed: int, worker_id: int) -> np.random.Generator:
    """The load-time masking generator of one DataLoader worker."""
    return np.random.default_rng([seed, worker_id])


class TaskRecordDataset(Dataset):
    """The records of one task's files, with the load-time transforms:
    MLM's 80-10-10 token masking (tasks.py:12-52), MRC's view masking and
    zeroed features (tasks.py:142-153,192-194), and `txt_masks`."""

    def __init__(self, files: Sequence[str], task: str,
                 shapes: PretrainShapes, seed: int = 0):
        self.files = [RecordFile(p) for p in files]
        self.index = [(fi, i) for fi, f in enumerate(self.files)
                      for i in range(len(f))]
        self.task, self.shapes, self.seed = task, shapes, seed
        self._rng: Optional[np.random.Generator] = None

    def __len__(self) -> int:
        return len(self.index)

    def rng(self) -> np.random.Generator:
        if self._rng is None:
            info = torch.utils.data.get_worker_info()
            self._rng = worker_rng(self.seed,
                                   0 if info is None else info.id)
        return self._rng

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        fi, j = self.index[i]
        s = decode_record(self.files[fi][j])
        if self.task == "mlm":
            s["txt_ids"], s["txt_labels"] = mask_tokens(
                self.rng(), s["txt_ids"], self.shapes)
        elif self.task == "mrc":
            pick = sample_mrc_mask(self.rng(), s.pop("mrc_is_view"),
                                   self.shapes.mrc_mask_prob)
            vp_img = s["vp_img"].copy()
            vp_img[int(s["last_step"])][pick] = 0.0
            s["vp_img"] = vp_img
            s["vp_view_mrc_masks"] = pick
        s["txt_masks"] = s["txt_ids"] != self.shapes.pad_token_id
        return s

    def __getstate__(self):
        return {**self.__dict__, "_rng": None}


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack samples into a `sample_batch`-layout dict of numpy arrays."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def build_task_loader(files: Sequence[str], task: str,
                      shapes: PretrainShapes, batch_size: int, *,
                      seed: int = 0, shuffle: bool = True,
                      num_workers: int = 0) -> DataLoader:
    """One DataLoader for one proxy task: full batches only, shuffled
    by a generator seeded `seed`, masks drawn per worker."""
    ds = TaskRecordDataset(files, task, shapes, seed)
    gen = torch.Generator().manual_seed(seed)
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                      drop_last=True, num_workers=num_workers,
                      collate_fn=collate, generator=gen,
                      persistent_workers=num_workers > 0)


class MetaLoader:
    """MetaLoader (loader.py:18-88): the next task from a multinomial over
    `ratios` with a shared seed, then a batch from that task's loader; a
    loader that runs out starts its next epoch."""

    def __init__(self, loaders: Dict[str, DataLoader],
                 ratios: Sequence[float], seed: int = 0):
        if not loaders:
            raise ValueError("need at least one task loader")
        self.tasks = list(loaders)
        self.loaders = loaders
        self.iters = {t: iter(dl) for t, dl in loaders.items()}
        p = np.asarray(list(ratios), np.float64)
        self.p = p / p.sum()
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Tuple[str, Dict[str, np.ndarray]]]:
        return self

    def __next__(self) -> Tuple[str, Dict[str, np.ndarray]]:
        task = self.tasks[self.rng.choice(len(self.tasks), p=self.p)]
        try:
            return task, next(self.iters[task])
        except StopIteration:
            self.iters[task] = iter(self.loaders[task])
        try:
            return task, next(self.iters[task])
        except StopIteration:
            # a StopIteration escaping __next__ would end training
            # silently at an arbitrary step
            raise RuntimeError(f"task {task!r} yields no full batch "
                               "(fewer records than the batch size?)"
                               ) from None
