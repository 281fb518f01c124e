"""Shared-memory observation plane for the env worker pool (counterpart
of `etpnav_tpu/env/shm_transport.py`).

habitat's VectorEnv ships every observation through a pickled pipe:
serialise, pipe write, read and deserialise are 3-4 passes over ~2.6 MB
of RGB-D panorama per env per step. Here the fixed-shape observation
arrays travel through a per-worker shared-memory region instead: the
worker writes each array once, the parent maps views of it and gathers
them straight into the contiguous host batch the device feed consumes
(`native.stack_arrays`, native/io_core.cpp). Control messages stay on
the pipe, so the strict request/reply protocol, and with it the crash
detection, is unchanged.

Layout per worker: a 64-byte header (the int64 write sequence number)
then one 64-byte-aligned slot per observation field. A worker holds one
observation in flight: the parent consumes (or copies) its views before
it sends that worker the next command, which `ProcessVectorEnv`'s
request/reply alternation guarantees. Observation keys outside the spec
(the instruction, small scalars) ride the pipe.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
from multiprocessing import shared_memory
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from etpnav_tpu_torch.env.protocol import StepResult

SHM_TOKEN = "__shm_obs__"
_HEADER = 64           # one cache line for the sequence counter
_ALIGN = 64


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class ObsSpec:
    """Ordered {name: (shape, dtype)} with a fixed slot layout."""

    def __init__(self, fields: Mapping[str, Tuple[tuple, Any]]):
        self.fields: Dict[str, Tuple[tuple, np.dtype]] = {}
        self.offsets: Dict[str, int] = {}
        off = _HEADER
        for name in sorted(fields):
            shape, dtype = fields[name]
            shape = tuple(int(s) for s in shape)
            dtype = np.dtype(dtype)
            self.fields[name] = (shape, dtype)
            self.offsets[name] = off
            off += _aligned(int(np.prod(shape)) * dtype.itemsize)
        self.nbytes = off

    @classmethod
    def from_example(cls, obs: Mapping[str, np.ndarray]) -> "ObsSpec":
        return cls({k: (v.shape, v.dtype) for k, v in obs.items()
                    if isinstance(v, np.ndarray)})

    def __eq__(self, other):
        return isinstance(other, ObsSpec) and self.fields == other.fields

    def __repr__(self):
        return f"ObsSpec({self.fields})"


class ShmObsChannel:
    """One worker's observation region; the parent creates it, the worker
    attaches.

    The worker maps /dev/shm/<name> with mmap rather than attaching
    through SharedMemory(name=...), which registers the segment with a
    resource tracker (CPython gh-82300): a spawned or forkserver worker's
    tracker would unlink the live segment when the worker exits. The
    creating parent owns the segment alone and unlinks it on close()."""

    def __init__(self, spec: ObsSpec, name: Optional[str] = None,
                 create: bool = False):
        self.spec = spec
        self._shm = None
        self._mmap = None
        self._owner = bool(create)
        if create:
            self._shm = shared_memory.SharedMemory(create=True,
                                                   size=spec.nbytes)
            self._name = self._shm.name
            buf = self._shm.buf
        else:
            self._name = name
            path = f"/dev/shm/{name.lstrip('/')}"
            if os.path.exists(path):
                fd = os.open(path, os.O_RDWR)
                try:
                    self._mmap = mmap.mmap(fd, spec.nbytes)
                finally:
                    os.close(fd)
                buf = memoryview(self._mmap)
            else:               # no /dev/shm: the tracked attach
                self._shm = shared_memory.SharedMemory(name=name)
                buf = self._shm.buf
        self._buf = buf
        self._seq = np.ndarray((1,), np.int64, buffer=buf, offset=0)
        if create:
            self._seq[0] = 0
        self._views: Dict[str, np.ndarray] = {
            fname: np.ndarray(shape, dtype, buffer=buf,
                              offset=spec.offsets[fname])
            for fname, (shape, dtype) in spec.fields.items()}

    @property
    def name(self) -> str:
        return self._name

    def write(self, obs: Mapping[str, np.ndarray]) -> int:
        """Worker side: copy the spec'd arrays in; returns the new seq."""
        for fname, (shape, dtype) in self.spec.fields.items():
            a = obs[fname]
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(
                    f"shm obs field {fname!r}: got {a.shape}/{a.dtype}, "
                    f"spec says {shape}/{dtype}")
            self._views[fname][...] = a
        self._seq[0] += 1
        return int(self._seq[0])

    def read(self, seq: int, copy: bool = False) -> Dict[str, np.ndarray]:
        """Parent side: read-only views (or copies) of the worker's last
        write. Views are valid until the next command to that worker;
        `seq` (from the pipe token) guards against protocol faults."""
        if int(self._seq[0]) != seq:
            raise RuntimeError(
                f"stale shm observation: header seq {int(self._seq[0])} "
                f"!= token seq {seq}")
        if copy:
            return {k: v.copy() for k, v in self._views.items()}
        out = {}
        for k, v in self._views.items():
            ro = v[...]
            ro.flags.writeable = False
            out[k] = ro
        return out

    def close(self):
        # drop this object's numpy views before closing the mapping
        self._views = {}
        self._seq = None
        self._buf = None
        try:
            if self._shm is not None:
                self._shm.close()
            elif self._mmap is not None:
                self._mmap.close()
        except BufferError:
            # a caller still holds zero-copy views: the mapping goes with
            # the process, and the unlink below still frees the segment
            # once the last mapping drops
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# reply encoding: applied to reset/step replies in the worker loop
# ---------------------------------------------------------------------------

def _is_obs(x, spec: ObsSpec) -> bool:
    return isinstance(x, dict) and all(k in x for k in spec.fields)


def encode_result(channel: ShmObsChannel, res: Any) -> Any:
    """Replace the (one) observation dict inside a reset/step reply with
    a pipe token: the spec'd arrays go through shared memory, the other
    keys ride the token. Replies without an observation pass unchanged."""
    spec = channel.spec

    def enc_obs(obs: dict) -> dict:
        seq = channel.write(obs)
        extra = {k: v for k, v in obs.items() if k not in spec.fields}
        return {SHM_TOKEN: seq, "extra": extra}

    if _is_obs(res, spec):
        return enc_obs(res)
    if isinstance(res, StepResult):
        if _is_obs(res.observation, spec):
            return dataclasses.replace(res, observation=enc_obs(
                res.observation))
        return res
    if isinstance(res, (list, tuple)):
        found = [i for i, x in enumerate(res)
                 if _is_obs(x, spec) or (isinstance(x, StepResult)
                                         and _is_obs(x.observation, spec))]
        if len(found) > 1:
            raise RuntimeError(
                "shm transport holds one observation per reply; got "
                f"{len(found)} (is this a num_envs>1 worker?)")
        if not found:
            return res
        out = list(res)
        out[found[0]] = encode_result(channel, out[found[0]])
        return type(res)(out)
    return res


def decode_result(channel: ShmObsChannel, res: Any,
                  copy: bool = False) -> Any:
    """Parent-side inverse of encode_result."""
    def dec_obs(token: dict) -> dict:
        obs = channel.read(token[SHM_TOKEN], copy=copy)
        obs.update(token.get("extra", {}))
        return obs

    if isinstance(res, dict) and SHM_TOKEN in res:
        return dec_obs(res)
    if isinstance(res, StepResult):
        if isinstance(res.observation, dict) and SHM_TOKEN in res.observation:
            return dataclasses.replace(
                res, observation=dec_obs(res.observation))
        return res
    if isinstance(res, (list, tuple)):
        return type(res)(decode_result(channel, x, copy=copy) for x in res)
    return res
