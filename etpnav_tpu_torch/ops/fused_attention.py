"""K-ATT: the attention kernel of the port, its wrapper and its plain
version.

Replaces the Pallas TPU kernels `fused_attention_nhd`,
`fused_attention`, `fused_attention_xbatch` and the forward of
`fused_bias_attention` (`etpnav_tpu/ops/pallas_attention.py`).
`fused_attention_xbatch` is per-sample unbiased attention on the natural
(B, L, H*hd) layout, K-ATT's function at the CLIP shape: its
block-diagonal cross-batch GEMM only fills the TPU's 128x128 matrix unit
and is not carried over. The CUDA C++ source,
`csrc/attention.cu`, says what bounds the kernel on an H100 and what
its design does about it.

Layout contract: q (B, H, Lq, hd), k and v (B, H, Lk, hd), in any
strides whose last one is 1 — the natural projection output
`x.view(B, L, H, hd).transpose(1, 2)` and a head-leading tensor are both
read in place. The output is (B, H, Lq, hd) laid out in memory as
(B, Lq, H, hd), so `out.transpose(1, 2).reshape(B, Lq, H * hd)` feeds the
output projection with no copy. The bias, when given, is fp32 and
broadcastable to (B, Lq, Lk) (a 4-D bias must have a head dim of 1): it is
shared by all heads, and broadcast dims are read with stride 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from etpnav_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)

#: launches of the CUDA kernel (wrapper) and calls of the plain version
attention_fwd_launches = cuda_build.LaunchCounter()
attention_plain_calls = cuda_build.LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
    i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    lib.etp_attention_fwd.argtypes = (
        [vp] * 5 + [i32] * 6 + [i64] * 15 + [ctypes.c_float, vp])
    lib.etp_attention_fwd.restype = ctypes.c_int


cuda_build.register_binder("attention", _bind)


def _bias_3d(bias: torch.Tensor, B: int, Lq: int, Lk: int) -> torch.Tensor:
    """Head-shared bias as a (B, Lq, Lk) fp32 view (broadcast dims get
    stride 0; nothing is copied for an fp32 bias)."""
    if bias.dim() == 4:
        if bias.shape[1] != 1:
            raise ValueError(f"bias {tuple(bias.shape)} is not head-shared")
        bias = bias[:, 0]
    return bias.float().expand(B, Lq, Lk)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], scale: float
                    ) -> torch.Tensor:
    """The plain PyTorch version of K-ATT, with the kernel's numerics:
    fp32 logits, max and sum; unnormalised p rounded to the input dtype
    before p.v (fp32 accumulation); the division by the sum last."""
    attention_plain_calls.add()
    return softmax_attention(q, k, v, bias, scale)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor], scale: float
                      ) -> torch.Tensor:
    """`attention_plain`'s arithmetic, uncounted, for the plain versions
    of other kernels that attend the same way."""
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + _bias_3d(bias, B, Lq, Lk)[:, None]
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    ctx = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return (ctx / denom).to(q.dtype)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], scale: float
                  ) -> torch.Tensor:
    """softmax(q.k^T * scale + bias) . v per head. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention_fwd: dtype {q.dtype} not supported")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"attention_fwd: head dim {hd} not supported "
                         f"(built for {_HEAD_DIMS})")
    for name, t, want in (("k", k, (B, H, Lk, hd)), ("v", v, (B, H, Lk, hd))):
        if tuple(t.shape) != want:
            raise ValueError(f"attention_fwd: {name} shape "
                             f"{tuple(t.shape)} != {want}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"attention_fwd: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"attention_fwd: {name} head dim not "
                             "contiguous")
    if Lq < 1 or Lk < 1:
        raise ValueError("attention_fwd: empty sequence")
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("attention_fwd: bias on another device")
        bias = _bias_3d(bias, B, Lq, Lk)
        sb = bias.stride()
        bias_ptr = bias.data_ptr()
    else:
        sb = (0, 0, 0)
        bias_ptr = None
    out = torch.empty(B, Lq, H, hd, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lib = cuda_build.load("attention")
    sq, sk, sv, so = q.stride(), k.stride(), v.stride(), out.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.etp_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), _DTYPES[q.dtype], B, H, Lq, Lk, hd,
            sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2],
            so[0], so[1], so[2], sb[0], sb[1], sb[2], float(scale), stream)
    cuda_build.check(err, "attention_fwd")
    attention_fwd_launches.add()
    return out
