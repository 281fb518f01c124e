"""K-BLOCK: the post-norm BERT self-attention sub-block as one op of the
port, its wrapper and its plain version.

Replaces the Pallas TPU kernel `fused_attention_block`
(`etpnav_tpu/ops/pallas_attention.py`), which computes
`LN(x + (softmax(q.k^T * s + bias[b]) . v) . Wo + bo)` with the q/k/v/o
projections inside the kernel, for inference. The CUDA C++ source,
`csrc/attention_block.cu`, holds the chain (the q/k/v GEMM, attention per
(sample, head), the output GEMM with bo and the residual, the row
LayerNorm) written by hand, and says what bounds it on an H100 and what
its design does about it. Its rounding points are the Pallas kernel's,
not the port's unfused `self_attention_block`'s: p is normalised in fp32
before it is rounded for p.v, and the output projection plus bo plus the
residual stays fp32 into the LayerNorm.

The JAX package routes no model through its kernel, and the port routes
none through this one: `self_attention_block` stays the BERT stacks' path.

Layout contract: x (B, L, D) contiguous, D = heads * 64, 1 <= L <= 224 on
the card; `params` an `AttentionBlock` ({attn: {q, k, v}, out: {dense,
ln}}) whose fp32 parameters lie on x's device (in bf16 the chain rounds
the fp32 weights to bf16 once per call, into a scratch the wrapper
allocates); `bias` fp32 broadcastable to
(B, L, L), shared by the heads (a 4-D bias has a head dim of 1), its
broadcast dims read with stride 0.
"""

from __future__ import annotations

import ctypes
import math

import torch

from etpnav_tpu_torch.ops import cuda_build
from etpnav_tpu_torch.ops.attention import AttentionBlock
from etpnav_tpu_torch.ops.fused_attention import _bias_3d

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64
_MAX_LEN = 224

#: launches of the CUDA kernel chain (wrapper) and calls of the plain
#: version
attention_block_launches = cuda_build.LaunchCounter()
attention_block_plain_calls = cuda_build.LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
    i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    lib.etp_attention_block.argtypes = (
        [vp] * 12 + [i64] * 3 + [vp] * 5 + [i32] * 5 + [ctypes.c_float] * 2
        + [vp])
    lib.etp_attention_block.restype = ctypes.c_int
    cuda_build.bind_dense_fault(lib)


cuda_build.register_binder("attention_block", _bind)


def attention_block_plain(x: torch.Tensor, params: AttentionBlock,
                          bias: torch.Tensor, num_heads: int,
                          eps: float) -> torch.Tensor:
    """The plain PyTorch version of K-BLOCK, with the rounding points of
    the Pallas kernel: each projection an fp32 sum of x-dtype operands
    plus the fp32 bias, rounded to x's dtype; logits fp32 times scale plus
    the bias; p normalised in fp32, then rounded; ctx an fp32 sum,
    rounded; the output projection plus bo plus the residual in fp32,
    unrounded into the LayerNorm; the LayerNorm's output rounded once."""
    attention_block_plain_calls.add()
    B, L, D = x.shape
    dt = x.dtype
    hd = D // num_heads
    x32 = x.float()

    def proj(lin, inp: torch.Tensor) -> torch.Tensor:
        w = lin.weight.to(dt).float()
        return torch.einsum("bld,nd->bln", inp.float(), w) + lin.bias

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.to(dt).float().view(B, L, num_heads, hd).transpose(1, 2)

    a = params.attn
    q, k, v = heads(proj(a.q, x)), heads(proj(a.k, x)), heads(proj(a.v, x))
    logits = (torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(hd))
              + _bias_3d(bias, B, L, L)[:, None])
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(dt).float()
    ctx = torch.einsum("bhqk,bhkd->bhqd", p, v).to(dt)
    ctx = ctx.transpose(1, 2).reshape(B, L, D)
    h = x32 + proj(params.out.dense, ctx)
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    ln = params.out.ln
    return ((h - mu) * torch.rsqrt(var + eps) * ln.weight
            + ln.bias).to(dt)


def attention_block(x: torch.Tensor, params: AttentionBlock,
                    bias: torch.Tensor, num_heads: int,
                    eps: float) -> torch.Tensor:
    """LN(x + Dense(MHA(x; bias))) for x (B, L, D), inference only. CPU
    tensors run the plain version; CUDA tensors launch the kernel chain or
    raise."""
    if x.device.type == "cpu":
        return attention_block_plain(x, params, bias, num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"attention_block: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"attention_block: needs contiguous (B, L, D) "
                         f"float32 or bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype} strides {x.stride()}")
    B, L, D = x.shape
    if D != num_heads * _HEAD_DIM or not 1 <= L <= _MAX_LEN:
        raise ValueError(f"attention_block: built for head dim {_HEAD_DIM} "
                         f"and L <= {_MAX_LEN}; got D={D}, {num_heads} "
                         f"heads, L={L}")
    lins = [params.attn.q, params.attn.k, params.attn.v, params.out.dense]
    tensors = [("ln.weight", params.out.ln.weight, (D,)),
               ("ln.bias", params.out.ln.bias, (D,))]
    for name, lin in zip("qkvo", lins):
        tensors += [(f"{name}.weight", lin.weight, (D, D)),
                    (f"{name}.bias", lin.bias, (D,))]
    for name, p, shape in tensors:
        if (p.dtype != torch.float32 or p.device != x.device
                or tuple(p.shape) != shape or not p.is_contiguous()):
            raise ValueError(f"attention_block: {name} must be contiguous "
                             f"float32 {shape} on {x.device}, got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")
    if bias.device != x.device:
        raise ValueError("attention_block: bias on another device")
    b3 = _bias_3d(bias, B, L, L)
    sb = b3.stride()
    M = B * L
    qkv = torch.empty(3, M, D, dtype=x.dtype, device=x.device)
    ctx = torch.empty(M, D, dtype=x.dtype, device=x.device)
    h32 = torch.empty(M, D, dtype=torch.float32, device=x.device)
    w_bf16 = (torch.empty(4, D, D, dtype=torch.bfloat16, device=x.device)
              if x.dtype == torch.bfloat16 else None)
    out = torch.empty_like(x)
    lib = cuda_build.load("attention_block")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.etp_attention_block(
            x.data_ptr(), *(t.data_ptr() for lin in lins
                            for t in (lin.weight, lin.bias)),
            params.out.ln.weight.data_ptr(), params.out.ln.bias.data_ptr(),
            b3.data_ptr(), sb[0], sb[1], sb[2],
            None if w_bf16 is None else w_bf16.data_ptr(), qkv.data_ptr(),
            ctx.data_ptr(), h32.data_ptr(), out.data_ptr(),
            _DTYPES[x.dtype], B, L, D, num_heads, float(eps),
            1.0 / math.sqrt(_HEAD_DIM), stream)
    cuda_build.check(err, "attention_block")
    attention_block_launches.add()
    return out
