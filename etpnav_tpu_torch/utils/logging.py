"""Observability: tensorboard scalars, the per-phase timer and the port's
tracer (counterpart of `etpnav_tpu/utils/logging.py`).

The reference's TensorboardLogger (pretrain_src utils/logger.py:27-66);
StepTimer splits a loop's wall time by phase.

The tracer records named spans on `time.perf_counter()`, the clock a
torch.profiler timeline can be mapped onto. Each span keeps its name,
start and end, its parent (the innermost span open on its thread when it
began), its thread and a key that ties a unit of work together: (sid,
step) for a served request, the batch id for a served batch,
(iteration, step) in the trainer. A span opened with a CUDA `device`
also records a CUDA event on the device's current stream at each end;
its device milliseconds are resolved by `export()`, after a synchronise,
so that recording never waits for the device. Spans are kept in a
bounded ring, the oldest dropped first and counted.

Tracing is off until `enable()`; off, `span()` and `sequence()` return
one shared no-op context and nothing is recorded. The process has one
tracer: the module functions below act on it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Optional


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


class _NoSpan:
    """The shared context `span()` and `sequence()` return while tracing
    is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def next(self, name: str, key=None, device=None, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


def _cuda(device):
    """The CUDA device a span times on, or None (no device, or a CPU
    one)."""
    if device is None:
        return None
    import torch
    device = torch.device(device)
    return device if device.type == "cuda" else None


class _Span:
    __slots__ = ("tracer", "id", "name", "key", "attrs", "device", "t0",
                 "t1", "parent", "thread", "events")

    def __init__(self, tracer: "Tracer", name: str, key, device, attrs):
        self.tracer, self.name, self.key = tracer, name, key
        self.device, self.attrs = _cuda(device), attrs
        self.id = next(tracer._ids)
        self.events = None

    def __enter__(self):
        stack = self.tracer._stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        if self.key is None and top is not None:
            self.key = top.key
        self.thread = threading.get_ident()
        stack.append(self)
        if self.device is not None:
            import torch
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.events is not None:
            import torch
            self.events[1].record(torch.cuda.current_stream(self.device))
        stack = self.tracer._stack()
        if self in stack:
            # a child an exception left open goes with its parent
            while stack.pop() is not self:
                pass
        self.tracer._keep(self)
        return False

    def as_record(self) -> dict:
        ms = None
        if self.events is not None:
            ms = self.events[0].elapsed_time(self.events[1])
        return {"id": self.id, "name": self.name, "t0": self.t0,
                "t1": self.t1, "parent": self.parent,
                "thread": self.thread, "key": self.key, "device_ms": ms,
                **self.attrs}


class _Sequence:
    """Consecutive spans: each `next()` ends the open one and begins the
    next, nested where the sequence was opened; leaving the `with` ends
    the last. A key given to `next()` holds for the following ones."""

    def __init__(self, tracer: "Tracer"):
        self.tracer, self.cur, self.key = tracer, None, None

    def __enter__(self):
        return self

    def next(self, name: str, key=None, device=None, **attrs) -> None:
        self.__exit__(None, None, None)
        if key is not None:
            self.key = key
        self.cur = _Span(self.tracer, name, self.key, device, attrs)
        self.cur.__enter__()

    def __exit__(self, *exc):
        if self.cur is not None:
            self.cur.__exit__(*exc)
            self.cur = None
        return False


class Tracer:
    """Spans into a bounded ring (see the module's docstring)."""

    def __init__(self, capacity: int = 1 << 16):
        self.on = False
        self._ring: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def enable(self) -> None:
        """Start recording into an empty ring."""
        with self._lock:
            self._ring.clear()
            self._dropped = 0
        self.on = True

    def disable(self) -> None:
        """Stop recording; what the ring holds stays for `export()`."""
        self.on = False

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _keep(self, span: _Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(span)

    def span(self, name: str, key=None, device=None, **attrs):
        """A span as a context; `key` defaults to the parent's; with a
        CUDA `device` it is device-timed. `attrs` go into its record."""
        if not self.on:
            return NO_SPAN
        return _Span(self, name, key, device, attrs)

    def sequence(self):
        """A context whose `next(name, key=None, device=None, **attrs)`
        opens consecutive spans (`_Sequence`)."""
        if not self.on:
            return NO_SPAN
        return _Sequence(self)

    def record(self, name: str, t0: float, t1: float, key=None,
               thread: Optional[int] = None, **attrs) -> None:
        """A span whose ends were taken elsewhere (perf_counter seconds),
        on `thread` (the caller's by default), with no parent."""
        if not self.on:
            return
        sp = _Span(self, name, key, None, attrs)
        sp.t0, sp.t1, sp.parent = t0, t1, None
        sp.thread = threading.get_ident() if thread is None else thread
        self._keep(sp)

    def current_key(self):
        """The key of the innermost span open on this thread, or None."""
        if not self.on:
            return None
        stack = self._stack()
        return stack[-1].key if stack else None

    def export(self) -> dict:
        """{"spans": plain records of the kept spans, in the order they
        ended, "dropped": how many the ring let go}. Synchronises the
        devices of device-timed spans first."""
        with self._lock:
            kept, dropped = list(self._ring), self._dropped
        devices = {s.device for s in kept if s.events is not None}
        if devices:
            import torch
            for d in devices:
                torch.cuda.synchronize(d)
        return {"spans": [s.as_record() for s in kept], "dropped": dropped}


_TRACER = Tracer()
enable = _TRACER.enable
disable = _TRACER.disable
span = _TRACER.span
sequence = _TRACER.sequence
record = _TRACER.record
current_key = _TRACER.current_key
export = _TRACER.export


def is_on() -> bool:
    """Whether the process's tracer is recording."""
    return _TRACER.on


class StepTimer:
    """Per-phase wall-clock accounting (rollout vs learn), with windowed
    means; each phase is also the span `train.<name>` while tracing is
    on. A phase that ends in device work must synchronise inside it, or
    its time lands in the next phase."""

    def __init__(self, window: int = 100):
        self._acc: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))

    @contextlib.contextmanager
    def phase(self, name: str, key=None):
        t0 = time.perf_counter()
        try:
            with span(f"train.{name}", key=key):
                yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def last(self, name: str) -> float:
        """Seconds of the latest `name` phase."""
        return self._acc[name][-1]

    def means(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._acc.items() if v}
