"""K-PRENORM: CLIP's pre-norm attention half-block as one op of the
port, its wrapper and its plain version.

Replaces the Pallas TPU kernels `fused_prenorm_attention_v2` and
`fused_prenorm_attention` (`etpnav_tpu/ops/pallas_attention.py`), which
compute the same function, `x + o(MHA(LN(x)))`, with the q/k/v/o
projections inside the kernel. The CUDA C++ source,
`csrc/prenorm_attention.cu`, holds the whole chain (LayerNorm, the
projections, attention, the output projection with the residual) written
by hand, and says what bounds it on an H100 and what its design does
about it.

Layout contract: x (B, L, D) contiguous, D = heads * 64, L <= 64 on the
card; `ln` is a `LayerNorm` and `attn` an `MHA` (q, k, v, o `Linear`s)
whose fp32 parameters lie on x's device. In bf16 the chain rounds the
fp32 weights to bf16 once per call, into a scratch the wrapper
allocates.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn as nn

from etpnav_tpu_torch.ops import cuda_build
from etpnav_tpu_torch.ops.fused_attention import softmax_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64
_MAX_LEN = 64

#: launches of the CUDA kernel chain (wrapper) and calls of the plain
#: version
prenorm_attention_launches = cuda_build.LaunchCounter()
prenorm_attention_plain_calls = cuda_build.LaunchCounter()
#: launches of the chains' bf16 GEMM alone (`gemm_bf16`)
gemm_bf16_launches = cuda_build.LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
    i32, vp = ctypes.c_int, ctypes.c_void_p
    lib.etp_prenorm_attention.argtypes = (
        [vp] * 16 + [i32] * 5 + [ctypes.c_float] * 2 + [vp])
    lib.etp_prenorm_attention.restype = ctypes.c_int
    lib.etp_round_bf16.argtypes = [vp, vp, i32, vp]
    lib.etp_round_bf16.restype = ctypes.c_int
    lib.etp_gemm_bf16.argtypes = [vp] * 4 + [i32] * 3 + [vp]
    lib.etp_gemm_bf16.restype = ctypes.c_int
    cuda_build.bind_dense_fault(lib)


cuda_build.register_binder("prenorm_attention", _bind)


def round_bf16(w: torch.Tensor) -> torch.Tensor:
    """A contiguous fp32 tensor rounded to bf16 (nearest even) by the
    chain's weight-rounding kernel, `round_bf16_kernel`, which the bf16
    GEMMs of K-PRENORM and K-BLOCK read; `.to(torch.bfloat16)` on the
    CPU. The kernel must equal that cast bit for bit."""
    if w.device.type == "cpu":
        return w.to(torch.bfloat16)
    if (w.device.type != "cuda" or w.dtype != torch.float32
            or not w.is_contiguous() or w.numel() % 4):
        raise ValueError(f"round_bf16: needs a contiguous float32 CUDA "
                         f"tensor of 4k elements, got {tuple(w.shape)} "
                         f"{w.dtype} on {w.device}")
    out = torch.empty(w.shape, dtype=torch.bfloat16, device=w.device)
    lib = cuda_build.load("prenorm_attention")
    with torch.cuda.device(w.device):
        err = lib.etp_round_bf16(w.data_ptr(), out.data_ptr(), w.numel(),
                                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "round_bf16")
    return out


def gemm_bf16_plain(a: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The plain version of the chains' bf16 GEMM: (M, K) bf16 times the
    (N, K) bf16 weight transposed, an fp32 sum plus the fp32 bias,
    rounded once to bf16."""
    return (a.float() @ w.float().t() + bias).to(torch.bfloat16)


def gemm_bf16(a: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """out (M, N) = a (M, K) . w (N, K)^T + bias (N,) on the bf16 GEMM of
    K-PRENORM and K-BLOCK (`csrc/dense.cuh`: wgmma fed by TMA), with the
    tile configuration the chains pick for this shape, for measuring it
    alone. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, w, bias)
    M, K = a.shape
    N = w.shape[0]
    if (a.device.type != "cuda" or a.dtype != torch.bfloat16
            or w.dtype != torch.bfloat16 or bias.dtype != torch.float32
            or tuple(w.shape) != (N, K) or tuple(bias.shape) != (N,)
            or not (a.is_contiguous() and w.is_contiguous()
                    and bias.is_contiguous())
            or w.device != a.device or bias.device != a.device):
        raise ValueError(f"gemm_bf16: needs contiguous bf16 a (M, K), w "
                         f"(N, K) and fp32 bias (N,) on one CUDA device, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(w.shape)} "
                         f"{w.dtype}, {tuple(bias.shape)} {bias.dtype}")
    out = torch.empty(M, N, dtype=torch.bfloat16, device=a.device)
    lib = cuda_build.load("prenorm_attention")
    with torch.cuda.device(a.device):
        err = lib.etp_gemm_bf16(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), M, N, K,
                                torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "gemm_bf16")
    gemm_bf16_launches.add()
    return out


def prenorm_attention_plain(x: torch.Tensor, ln: nn.Module, attn: nn.Module,
                            num_heads: int, eps: float) -> torch.Tensor:
    """The plain PyTorch version of K-PRENORM, with the rounding points
    of the Pallas kernel: LN in fp32, rounded to x's dtype; each
    projection an fp32 sum of products of x-dtype operands plus the fp32
    bias, rounded; attention as K-ATT computes it; the output projection
    plus bo and the residual in fp32, rounded once."""
    prenorm_attention_plain_calls.add()
    B, L, D = x.shape
    dt = x.dtype
    hd = D // num_heads
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    a = ((x32 - mu) * torch.rsqrt(var + eps) * ln.weight
         + ln.bias).to(dt)

    def proj(lin: nn.Module, inp: torch.Tensor) -> torch.Tensor:
        w = lin.weight.to(dt).float()
        return torch.einsum("bld,nd->bln", inp.float(), w) + lin.bias

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.to(dt).view(B, L, num_heads, hd).transpose(1, 2)

    ctx = softmax_attention(heads(proj(attn.q, a)), heads(proj(attn.k, a)),
                            heads(proj(attn.v, a)), None,
                            1.0 / math.sqrt(hd))
    ctx = ctx.transpose(1, 2).reshape(B, L, D)
    return (x32 + proj(attn.o, ctx)).to(dt)


def prenorm_attention(x: torch.Tensor, ln: nn.Module, attn: nn.Module,
                      num_heads: int, eps: float) -> torch.Tensor:
    """x + o(MHA(LN(x))) for x (B, L, D). CPU tensors run the plain
    version; CUDA tensors launch the kernel chain or raise."""
    if x.device.type == "cpu":
        return prenorm_attention_plain(x, ln, attn, num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"prenorm_attention: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"prenorm_attention: needs contiguous (B, L, D) "
                         f"float32 or bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype} strides {x.stride()}")
    B, L, D = x.shape
    if D != num_heads * _HEAD_DIM or not 1 <= L <= _MAX_LEN:
        raise ValueError(f"prenorm_attention: built for head dim "
                         f"{_HEAD_DIM} and L <= {_MAX_LEN}; got D={D}, "
                         f"{num_heads} heads, L={L}")
    params = [("ln.weight", ln.weight, (D,)), ("ln.bias", ln.bias, (D,))]
    for name in ("q", "k", "v", "o"):
        lin = getattr(attn, name)
        params += [(f"{name}.weight", lin.weight, (D, D)),
                   (f"{name}.bias", lin.bias, (D,))]
    for name, p, shape in params:
        if (p.dtype != torch.float32 or p.device != x.device
                or tuple(p.shape) != shape or not p.is_contiguous()):
            raise ValueError(f"prenorm_attention: {name} must be contiguous "
                             f"float32 {shape} on {x.device}, got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")
    M = B * L
    w_bf16 = (torch.empty(4, D, D, dtype=torch.bfloat16, device=x.device)
              if x.dtype == torch.bfloat16 else None)
    a = torch.empty(M, D, dtype=x.dtype, device=x.device)
    qkv = torch.empty(3, M, D, dtype=x.dtype, device=x.device)
    ctx = torch.empty(M, D, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    lib = cuda_build.load("prenorm_attention")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.etp_prenorm_attention(
            x.data_ptr(), *(p.data_ptr() for _, p, _ in params),
            None if w_bf16 is None else w_bf16.data_ptr(), a.data_ptr(),
            qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(),
            _DTYPES[x.dtype], B, L, D, num_heads, float(eps),
            1.0 / math.sqrt(_HEAD_DIM), stream)
    cuda_build.check(err, "prenorm_attention")
    prenorm_attention_launches.add()
    return out
