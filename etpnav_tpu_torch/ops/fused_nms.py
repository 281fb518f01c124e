"""K-NMS: the waypoint-heatmap NMS kernel of the port, its wrapper and
its plain version.

Replaces the Pallas TPU kernel `fused_heatmap_nms`
(`etpnav_tpu/ops/pallas_nms.py`) together with the softmax and row wrap
that ran beside it and the `extract_candidates` chain after it: one
launch writes the map and the K candidate slots. The CUDA C++ source,
`csrc/heatmap_nms.cu`, says what bounds the kernel on an H100 and what
its design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from etpnav_tpu_torch.ops import cuda_build
from etpnav_tpu_torch.ops.nms import extract_candidates, heatmap_nms

#: launches of the CUDA kernel (wrapper) and calls of the plain version
heatmap_nms_launches = cuda_build.LaunchCounter()
heatmap_nms_plain_calls = cuda_build.LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
    i32, vp = ctypes.c_int, ctypes.c_void_p
    lib.etp_heatmap_nms.argtypes = [vp] * 4 + [i32] * 4 + [
        ctypes.c_float, ctypes.c_float, vp]
    lib.etp_heatmap_nms.restype = ctypes.c_int


cuda_build.register_binder("heatmap_nms", _bind)

Candidates = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def heatmap_nms_plain(logits: torch.Tensor, max_predictions: int = 5,
                      sigma: Tuple[float, float] = (7.0, 5.0)
                      ) -> torch.Tensor:
    """Plain version of K-NMS's map: softmax over all A*D cells, row wrap,
    then `ops.nms.heatmap_nms`. (B, A, D) logits -> (B, A+2, D) fp32 map.
    The softmax is e / s, e = exp(x - max), with the kernel's exact sum
    (`csrc/heatmap_nms.cu`): each e truncated to a multiple of 2^-40, the
    integers summed in int64, the sum rounded once to fp32. It is the
    same in any order, so the kernel's map equals this one bit for bit."""
    heatmap_nms_plain_calls.add()
    B, A, D = logits.shape
    x = logits.reshape(B, A * D).float()
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    fixed = (e * 2.0 ** 40).to(torch.int64).sum(dim=1, keepdim=True)
    prob = (e / (fixed.double() / 2.0 ** 40).float()).reshape(B, A, D)
    # wrap: row A-1 on top, row 0 at the bottom
    wrapped = torch.cat([prob[:, -1:], prob, prob[:, :1]], dim=1)
    return heatmap_nms(wrapped, max_predictions, sigma)


def heatmap_candidates_plain(logits: torch.Tensor, max_predictions: int = 5,
                             sigma: Tuple[float, float] = (7.0, 5.0)
                             ) -> Candidates:
    """Plain version of K-NMS: the map of `heatmap_nms_plain`, then the
    candidate slots `extract_candidates(map[:, 1:-1, :], K)`."""
    nms_map = heatmap_nms_plain(logits, max_predictions, sigma)
    return (nms_map,) + tuple(extract_candidates(nms_map[:, 1:-1, :],
                                                 max_predictions))


def heatmap_nms_fused(logits: torch.Tensor, max_predictions: int = 5,
                      sigma: Tuple[float, float] = (7.0, 5.0)
                      ) -> Candidates:
    """(B, A, D) fp32 logits -> (nms_map (B, A+2, D) fp32, the sparse
    wrapped NMS map `fused_heatmap_nms` returns; angle_idx, dist_idx
    (B, K) int64 and valid (B, K) bool, the slots `extract_candidates`
    gives of its rows 1..A). CPU tensors run the plain version; CUDA
    tensors launch the kernel, which writes all four, or raise."""
    if logits.device.type == "cpu":
        return heatmap_candidates_plain(logits, max_predictions, sigma)
    if logits.device.type != "cuda":
        raise ValueError(f"heatmap_nms_fused: unsupported device "
                         f"{logits.device}")
    if logits.dtype != torch.float32 or logits.dim() != 3:
        raise ValueError(f"heatmap_nms_fused: needs (B, A, D) float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    logits = logits.contiguous()
    B, A, D = logits.shape
    K = int(max_predictions)
    dev = logits.device
    out = torch.empty(B, A + 2, D, dtype=torch.float32, device=dev)
    slots = torch.empty(2, B, K, dtype=torch.int64, device=dev)
    valid = torch.empty(B, K, dtype=torch.bool, device=dev)
    lib = cuda_build.load("heatmap_nms")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.etp_heatmap_nms(
            logits.data_ptr(), out.data_ptr(), slots.data_ptr(),
            valid.data_ptr(), B, A, D, K, float(sigma[0]), float(sigma[1]),
            stream)
    cuda_build.check(err, "heatmap_nms_fused")
    heatmap_nms_launches.add()
    return out, slots[0], slots[1], valid
