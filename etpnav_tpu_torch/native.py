"""ctypes loaders for the native host cores (native/topo_core.cpp,
native/io_core.cpp).

The port's own copy of the JAX package's loaders, limited to what the
port calls: the APSP edge relax and the pairwise distance assembly of
`graph/topo_map.py` and the exact DTW of `metrics.py` (topo_core), and
the parallel gather that stacks the env workers' observations into one
host batch (io_core; `stack_arrays`). Each library builds lazily with
make/g++ on first use and is cached next to its source; every entry
point returns a "not available" value when it cannot be built, and the
caller then runs its numpy version.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libtopo_core.so")
_IO_SO_PATH = os.path.join(_NATIVE_DIR, "libio_core.so")

_lib = None
_io_lib = None
_lock = threading.Lock()
_tried = False
_io_tried = False


def _build(path: str = _SO_PATH) -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, os.path.basename(path)],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(path)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.warning("native build failed (%s); using numpy fallbacks", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO_PATH) and not _build():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        c_d = ctypes.POINTER(ctypes.c_double)
        c_i32 = ctypes.POINTER(ctypes.c_int32)
        c_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.apsp_relax_edge.argtypes = [c_d, c_i32, c_i32, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_double]
        lib.apsp_relax_edge.restype = None
        lib.pairwise_assemble.argtypes = [c_d, ctypes.c_int64, c_i64, c_d,
                                          ctypes.c_int64, ctypes.c_double,
                                          c_d]
        lib.pairwise_assemble.restype = None
        lib.dtw.argtypes = [c_d, ctypes.c_int64, c_d, ctypes.c_int64]
        lib.dtw.restype = ctypes.c_double
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def apsp_relax_edge(D: np.ndarray, H: np.ndarray, Nx: np.ndarray,
                    u: int, v: int, w: float) -> bool:
    """Native in-place edge relax; returns False if native lib missing."""
    lib = get_lib()
    if lib is None:
        return False
    if not (D.flags.c_contiguous and H.flags.c_contiguous
            and Nx.flags.c_contiguous):
        raise ValueError("apsp_relax_edge needs C-contiguous matrices")
    lib.apsp_relax_edge(_ptr(D, ctypes.c_double), _ptr(H, ctypes.c_int32),
                        _ptr(Nx, ctypes.c_int32), D.shape[0], u, v, w)
    return True


def pairwise_assemble(D: np.ndarray, anchors: np.ndarray,
                      offsets: np.ndarray, scale: float
                      ) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    m = len(anchors)
    out = np.zeros((m, m), np.float64)
    anchors = np.ascontiguousarray(anchors, np.int64)
    offsets = np.ascontiguousarray(offsets, np.float64)
    lib.pairwise_assemble(_ptr(D, ctypes.c_double), D.shape[0],
                          _ptr(anchors, ctypes.c_int64),
                          _ptr(offsets, ctypes.c_double), m, scale,
                          _ptr(out, ctypes.c_double))
    return out


def dtw(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    """Native exact DTW of two (N, 3) paths; None if the library is
    missing."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    if a.shape[1] != 3 or b.shape[1] != 3:
        raise ValueError("dtw takes (N, 3) paths")
    return float(lib.dtw(_ptr(a, ctypes.c_double), a.shape[0],
                         _ptr(b, ctypes.c_double), b.shape[0]))


def get_io_lib() -> Optional[ctypes.CDLL]:
    global _io_lib, _io_tried
    with _lock:
        if _io_lib is not None or _io_tried:
            return _io_lib
        _io_tried = True
        if not os.path.exists(_IO_SO_PATH) and not _build(_IO_SO_PATH):
            return None
        lib = ctypes.CDLL(_IO_SO_PATH)
        lib.gather_copy.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
        lib.gather_copy.restype = None
        _io_lib = lib
        return _io_lib


def gather_copy(srcs, out: np.ndarray, nthreads: int = 0) -> bool:
    """Parallel memcpy of the C-contiguous `srcs` into consecutive
    segments of `out` (a flat byte buffer whose nbytes is their sum; the
    caller owns the layout). False when the library is missing."""
    lib = get_io_lib()
    if lib is None:
        return False
    n = len(srcs)
    ptrs = (ctypes.c_void_p * n)()
    sizes = np.empty(n, np.int64)
    for i, a in enumerate(srcs):
        if not a.flags.c_contiguous:
            raise ValueError("gather_copy sources must be C-contiguous")
        ptrs[i] = a.ctypes.data
        sizes[i] = a.nbytes
    if not out.flags.c_contiguous or out.nbytes != int(sizes.sum()):
        raise ValueError(f"gather_copy layout: out holds {out.nbytes} "
                         f"bytes, the sources {int(sizes.sum())}")
    lib.gather_copy(ptrs, _ptr(sizes, ctypes.c_int64),
                    out.ctypes.data_as(ctypes.c_void_p), n, nthreads)
    return True


def stack_arrays(arrays, out: Optional[np.ndarray] = None) -> np.ndarray:
    """np.stack through the native parallel gather when it is available:
    the rollout's batch assembly from the workers' (shared-memory)
    observation views."""
    a0 = arrays[0]
    if out is None:
        out = np.empty((len(arrays),) + a0.shape, a0.dtype)
    srcs = [np.ascontiguousarray(a, out.dtype) for a in arrays]
    if not gather_copy(srcs, out):
        for i, a in enumerate(srcs):
            out[i] = a
    return out
