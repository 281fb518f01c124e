"""One CUDA graph per input signature of a function of tensors.

`CapturedGraphs(fn)` runs `fn(*xs)` for CUDA tensors `xs` as the replay
of a graph captured at the first call with their signature (each
tensor's device, shape, strides and dtype, in order). A call with a
tensor that is not on a CUDA device runs `fn` eagerly, as does a call
made while the caller's stream is itself being captured: the enclosing
graph then takes fn's kernels. `eager(...)` runs `fn` eagerly whatever
its arguments, for callers whose own gate declines the graph. A capture
that fails raises.

The first call of a signature runs `fn` once on a side stream (its
kernels built, cuDNN's plans chosen; that run's result is the call's
output), then captures `fn` on that stream into the graph's own memory
pool with `capture_error_mode="thread_local"`, so that other threads'
CUDA calls go on meanwhile. A replay copies each input into the graph's
static inputs, replays, and returns a copy of the static output (of each
tensor, where `fn` returns a tuple or a dict of them, in the same keys
and order): no caller holds the graph's buffers. The graphs and their
pools are freed with this object.

`fn` reads its weights and constants from the tensors it closes over,
inside the captured work: weights copied into those tensors in place
are what the next replay reads. The launch counters of
`ops/cuda_build.py` stay true: a capture launches nothing, so what it
counted is taken back, and each replay counts it again.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

import torch

from etpnav_tpu_torch.ops import cuda_build


def _apply(f, out):
    """f of a tensor, or of each tensor of a tuple or of a dict."""
    if isinstance(out, dict):
        return {k: f(v) for k, v in out.items()}
    return tuple(map(f, out)) if isinstance(out, tuple) else f(out)


class _Graph:
    __slots__ = ("graph", "xs", "out", "launches", "done")


class CapturedGraphs:
    """`fn` as CUDA graph replays, one graph per input signature (see
    the module's docstring). `replays`, `captures` and `eager_calls`
    (calls whose first tensor is on a CUDA device that ran `fn`
    eagerly) count the calls."""

    def __init__(self, fn: Callable[..., object]):
        self.fn = fn
        self._graphs: Dict[tuple, _Graph] = {}
        # one caller at a time owns a graph's static buffers
        self._lock = threading.Lock()
        self.replays = self.captures = self.eager_calls = 0

    @staticmethod
    def engages(*xs: torch.Tensor) -> bool:
        """Whether a call on `xs` captures or replays a graph."""
        return (all(x.is_cuda for x in xs)
                and not torch.cuda.is_current_stream_capturing())

    def eager(self, *args, **kwargs):
        """`fn(*args, **kwargs)` run eagerly, counted in `eager_calls`
        where its first argument is on a CUDA device."""
        if args[0].is_cuda:
            with self._lock:
                self.eager_calls += 1
        return self.fn(*args, **kwargs)

    def __call__(self, *xs: torch.Tensor):
        if not self.engages(*xs):
            return self.eager(*xs)
        key = tuple((x.device, tuple(x.shape), x.stride(), x.dtype)
                    for x in xs)
        with self._lock, torch.cuda.device(xs[0].device):
            g = self._graphs.get(key)
            if g is None:
                out, self._graphs[key] = self._capture(xs)
                self.captures += 1
                return out
            stream = torch.cuda.current_stream()
            # the last caller's copy-out is done, whatever its stream
            stream.wait_event(g.done)
            for static, x in zip(g.xs, xs):
                static.copy_(x)
            g.graph.replay()
            out = _apply(torch.Tensor.clone, g.out)
            g.done.record(stream)
            self.replays += 1
        cuda_build.add_launches(g.launches)
        return out

    def _capture(self, xs: tuple):
        """Warm up and capture `fn` for the signature of xs: (the
        warm-up's output, the graph)."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        g = _Graph()
        g.xs = [torch.empty_like(x) for x in xs]
        for static, x in zip(g.xs, xs):
            static.copy_(x)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*g.xs)
        g.graph = torch.cuda.CUDAGraph()
        with cuda_build.recording_launches() as g.launches:
            with torch.cuda.graph(g.graph, stream=side,
                                  capture_error_mode="thread_local"):
                g.out = self.fn(*g.xs)
        cuda_build.add_launches(g.launches, -1)
        cur.wait_stream(side)
        _apply(lambda t: t.record_stream(cur), out)
        g.done = torch.cuda.Event()
        return out, g
