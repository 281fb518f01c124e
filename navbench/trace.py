"""The traced run's instruments, all from the benchmark's side of the
program's calls: synchronised host spans around the layer entry points,
the attention work counted from the shapes of the calls that ran, and a
torch.profiler window of device activity."""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from navbench.common import HBM_BYTES_PER_S, PEAK_FLOPS

# kernels that compute attention (K-ATT and K-ATT-BWD, csrc/attention*.cu)
ATTENTION_KERNELS = ("attention_fwd", "attention_bwd")


class Spans:
    """Named host-clock spans, each closed by a device synchronise, kept
    in memory: {name: [(start, end), ...]} in perf_counter seconds."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        self._lock = threading.Lock()
        self._wrapped = []

    def wrap(self, obj, attr: str, name: str) -> None:
        """Replace obj.attr by a timed, synchronised call of itself."""
        fn = getattr(obj, attr)

        sync = (torch.cuda.synchronize if torch.cuda.is_available()
                else (lambda: None))

        @functools.wraps(fn)
        def timed(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            with self._lock:
                self.spans[name].append((t0, time.perf_counter()))
            return out

        self._wrapped.append((obj, attr, fn))
        setattr(obj, attr, timed)

    def restore(self) -> None:
        """Put back every wrapped callable."""
        for obj, attr, fn in reversed(self._wrapped):
            setattr(obj, attr, fn)
        self._wrapped.clear()

    def label(self, t: float, order: Tuple[str, ...]) -> str:
        """The first span name of `order` that covers host time t."""
        for name in order:
            for a, b in self.spans.get(name, ()):
                if a <= t <= b:
                    return name
        return "other"


def attention_work(q, k, bias) -> Tuple[float, float]:
    """(bytes, FLOPs) of one attention forward: q, k, v read and the
    output written once, the stored bias elements read once; two
    products of B*H*Lq*Lk*hd multiply-adds."""
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    isz = q.element_size()
    nbytes = isz * (2 * B * H * Lq * hd + 2 * B * H * Lk * hd)
    if bias is not None:
        nbytes += 4 * bias.numel()
    return float(nbytes), 4.0 * B * H * Lq * Lk * hd


def attention_bwd_work(q, k, bias, dbias: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one attention backward: q, o, dO, k, v, the row
    log-sum-exp and the stored bias read once, dq, dk, dv (and an fp32
    d(bias)) written once; five products of B*H*Lq*Lk*hd
    multiply-adds."""
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    isz = q.element_size()
    nbytes = isz * (4 * B * H * Lq * hd + 4 * B * H * Lk * hd)
    nbytes += 4 * B * H * Lq
    if bias is not None:
        nbytes += 4 * bias.numel()
    if dbias:
        nbytes += 4 * B * Lq * Lk
    return float(nbytes), 10.0 * B * H * Lq * Lk * hd


def bound_s(nbytes: float, flops: float, prec: str) -> float:
    """The least time at the chip's peaks: the larger of bytes over HBM
    bandwidth and FLOPs over the precision's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[prec])


class AttentionCount:
    """Counts the attention work of the program's `attention` entry
    (`etpnav_tpu_torch.ops.attention.attention`, which every module's
    attention goes through) while `active`: the least time of each call
    at the chip's peaks, the backward's too where autograd records."""

    def __init__(self):
        from etpnav_tpu_torch.ops import attention as mod
        self._mod = mod
        self._orig = mod.attention
        self.active = False
        self.bound_s = 0.0
        self.calls = 0
        self._lock = threading.Lock()
        orig = self._orig

        def counted(q, k, v, bias, scale, *a, **kw):
            if self.active:
                prec = "bf16" if q.dtype == torch.bfloat16 else "fp32"
                b, f = attention_work(q, k, bias)
                t = bound_s(b, f, prec)
                if torch.is_grad_enabled() and any(
                        x is not None and x.requires_grad
                        for x in (q, k, v, bias)):
                    db = bias is not None and bias.requires_grad
                    b2, f2 = attention_bwd_work(q, k, bias, db)
                    t += bound_s(b2, f2, prec)
                with self._lock:
                    self.bound_s += t
                    self.calls += 1
            return orig(q, k, v, bias, scale, *a, **kw)

        mod.attention = counted

    def restore(self) -> None:
        self._mod.attention = self._orig


class DeviceWindow:
    """torch.profiler over a stretch of the run, device activity only
    (a rollout's host ops would cost tens of seconds to collect). A spin
    kernel launched on a side stream at the start ties the profiler's
    device clock to the host's perf_counter."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            self.t_mark = time.perf_counter()
            torch.cuda._sleep(1000)
        self.h0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.h1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def summary(self, spans: Optional[Spans] = None,
                order: Tuple[str, ...] = ()) -> dict:
        """busy_s (the union of device intervals), window_s, seconds by
        kernel name, the attention kernels' seconds, and the ten longest
        idle gaps named by the host span they fell in."""
        ev = [e for e in self.prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.time_range.end > e.time_range.start]
        mark = [e for e in ev if "sleep" in e.name or "spin" in e.name]
        offset = (mark[0].time_range.start / 1e6 - self.t_mark
                  if mark else None)
        ev = [e for e in ev if not mark or e is not mark[0]]
        iv = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6)
                    for e in ev)
        busy, gaps, cur = 0.0, [], None
        for a, b in iv:
            if cur is None:
                cur = [a, b]
            elif a <= cur[1]:
                cur[1] = max(cur[1], b)
            else:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
                cur = [a, b]
        if cur is not None:
            busy += cur[1] - cur[0]
        by_name = collections.Counter()
        for e in ev:
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        attn = sum(s for n, s in by_name.items()
                   if any(k in n for k in ATTENTION_KERNELS))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:10]:
            name = "unlabelled"
            if offset is not None and spans is not None:
                name = spans.label((a + b) / 2 - offset, order)
            named.append([name, b - a])
        return {"busy_s": busy, "window_s": self.h1 - self.h0,
                "by_name": dict(by_name), "attention_s": attn,
                "idle_gaps": named, "events": len(ev)}
