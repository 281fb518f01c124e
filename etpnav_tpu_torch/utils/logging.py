"""Observability: tensorboard scalars, running meters, phase timers and
profiler traces (counterpart of `etpnav_tpu/utils/logging.py`).

The reference's TensorboardLogger / RunningMeter (pretrain_src
utils/logger.py:27-90) and throughput counters; `trace()` records a
`torch.profiler` trace of the host and the card, and StepTimer splits a
loop's wall time by phase.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class RunningMeter:
    """Exponential moving average of a scalar (utils/logger.py:68-90)."""

    def __init__(self, name: str, smooth: float = 0.99):
        self.name = name
        self.smooth = smooth
        self._val: Optional[float] = None

    def update(self, v: float):
        self._val = v if self._val is None else (
            self._val * self.smooth + v * (1 - self.smooth))

    @property
    def val(self) -> Optional[float]:
        return self._val


class TensorboardLogger:
    """Thin tensorboard writer; falls back to JSONL when
    `torch.utils.tensorboard` cannot be imported, so logs are never
    silently dropped. With no logdir it writes nothing."""

    def __init__(self, logdir: Optional[str]):
        self._tb = None
        self._jsonl = None
        self.step = 0
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(logdir)
            except ImportError:
                self._jsonl = open(os.path.join(logdir, "scalars.jsonl"),
                                   "a")

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None):
        step = self.step if step is None else step
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": step}) + "\n")

    def add_scalars(self, scalars: Dict[str, float],
                    step: Optional[int] = None):
        for k, v in scalars.items():
            self.add_scalar(k, v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


class StepTimer:
    """Per-phase wall-clock accounting (rollout vs learn), with windowed
    means. A phase that ends in device work must synchronise inside it,
    or its time lands in the next phase."""

    def __init__(self, window: int = 100):
        self._acc: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def last(self, name: str) -> float:
        """Seconds of the latest `name` phase."""
        return self._acc[name][-1]

    def means(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._acc.items() if v}

    def reset(self):
        """Drop accumulated phases (e.g. to exclude the kernels' build
        and the allocator's growth from a measurement window)."""
        self._acc.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the host and, where there is one, the
    card, written as a Chrome trace (`trace.json`) into `logdir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
