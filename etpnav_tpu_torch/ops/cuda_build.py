"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and builds on its own into
`etpnav_tpu_torch/build/lib<name>-<hash>.so` (the directory is listed in
.gitignore; the hash covers the source, the shared headers and the
flags, so an edited source never loads a stale library). Nothing is built
or imported at module import: the first wrapper call on a CUDA tensor
builds what it needs, and `build_all()` starts one nvcc per source, all
at once.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("attention", "attention_bwd", "heatmap_nms", "groupnorm",
           "prenorm_attention", "attention_block", "moe_gemm")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# each library's argtypes, registered by the module that binds it
_binders: Dict[str, Callable[[ctypes.CDLL], None]] = {}
#: nvcc's -Xptxas -v report per source, from the builds of this process
PTXAS_REPORTS: Dict[str, str] = {}


def register_binder(name: str, binder: Callable[[ctypes.CDLL], None]):
    _binders[name] = binder


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "port's CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return path


def _target(name: str) -> str:
    """The library's path; its hash covers the source, every header of
    csrc/ (philox.cuh, dense.cuh and attention_tc.cuh are shared) and the
    flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for one source into a temporary file; None if built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp,
         os.path.join(CSRC_DIR, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp_path, proc.target, proc.src_name = tmp, target, name
    return proc


def _finish(proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(proc.tmp_path)
        raise RuntimeError(f"nvcc failed for {proc.src_name}.cu:\n{out}")
    PTXAS_REPORTS[proc.src_name] = out
    os.replace(proc.tmp_path, proc.target)


def build_all(names: List[str] = SOURCES) -> float:
    """Build every listed source in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        procs = [p for p in (_start(n) for n in names) if p is not None]
        errors = []
        for p in procs:
            try:
                _finish(p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_target(name))
            _binders[name](lib)
            _libs[name] = lib
        return _libs[name]


# the launches this thread counts inside `recording_launches()`
_recording = threading.local()


class LaunchCounter:
    """A thread-safe count of kernel launches or plain-version calls."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n
        counts = getattr(_recording, "counts", None)
        if counts is not None:
            counts[self] += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


@contextlib.contextmanager
def recording_launches():
    """Yields a `collections.Counter` of the launches this thread counts
    inside the block, per counter (other threads' launches are not in
    it): what a CUDA graph's capture records, which `add_launches` adds
    again at each replay."""
    outer = getattr(_recording, "counts", None)
    counts = _recording.counts = collections.Counter()
    try:
        yield counts
    finally:
        _recording.counts = outer


def add_launches(counts: collections.Counter, times: int = 1) -> None:
    """Adds `times` x each count of `counts` to its counter."""
    for counter, n in counts.items():
        counter.add(n * times)


# the words of csrc/dense.cuh's barrier fault record
_FAULT_WORDS = 9
_FAULT_KINDS = ("full", "empty")


def bind_dense_fault(lib: ctypes.CDLL) -> None:
    """Binds and allocates the barrier fault record of a library that
    includes `csrc/dense.cuh` (its binder calls this at load)."""
    lib.etp_dense_fault_init.argtypes = []
    lib.etp_dense_fault_init.restype = ctypes.c_int
    lib.etp_dense_fault.argtypes = [ctypes.POINTER(ctypes.c_uint)]
    lib.etp_dense_fault.restype = ctypes.c_int
    check(lib.etp_dense_fault_init(), "etp_dense_fault_init")


def dense_fault_report() -> Optional[str]:
    """What a bf16 GEMM's timed-out barrier wait recorded before it
    trapped (`mbar_wait`, csrc/dense.cuh), for every loaded library that
    has the record; None if no wait timed out. Reads pinned host memory
    only, so it works after the launch error has spoiled the CUDA
    context."""
    lines = []
    for name, lib in sorted(_libs.items()):
        if not hasattr(lib, "etp_dense_fault"):
            continue
        rec = (ctypes.c_uint * _FAULT_WORDS)()
        if lib.etp_dense_fault(rec):
            _, bm, bn, stages, kind, stage, parity, block, thread = rec
            lines.append(
                f"lib{name}: gemm_bf16_kernel<BM={bm}, BN={bn}, "
                f"STAGES={stages}> timed out in mbar_wait on "
                f"{_FAULT_KINDS[kind]}[{stage}], parity {parity} "
                f"(block {block}, thread {thread})")
    return "; ".join(lines) or None


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
