"""K-ATT and K-ATT-BWD: the attention kernels of the port, their wrappers,
their plain versions and the autograd Function that joins them.

K-ATT replaces the Pallas TPU kernels `fused_attention_nhd`,
`fused_attention`, `fused_attention_xbatch` and the forward of
`fused_bias_attention` (`etpnav_tpu/ops/pallas_attention.py`).
`fused_attention_xbatch` is per-sample unbiased attention on the natural
(B, L, H*hd) layout, K-ATT's function at the CLIP shape: its
block-diagonal cross-batch GEMM only fills the TPU's 128x128 matrix unit
and is not carried over. K-ATT-BWD replaces `fused_bias_attention`'s
custom VJP (:377-394). The CUDA C++ sources, `csrc/attention.cu` and
`csrc/attention_bwd.cu`, say what bounds each kernel on an H100 and what
its design does about it: bf16 launches run on tensor cores (mma.sync),
fp32 launches on CUDA cores. K-ATT with `out_layout="head"` also replaces
the TPU experiment `bdims_attention` (`tools/exp_attn_layout.py`), whose
function is K-ATT's with a head-leading output. K-ATT-CHEAP
(`attention_cheap`, the CHEAP instantiation in `csrc/attention.cu`)
replaces the TPU experiment `cheap_attention` (`tools/exp_attn_pack.py`):
bf16 logits and a constant-shift softmax with no max pass.

Layout contract: q (B, H, Lq, hd), k and v (B, H, Lk, hd), in any
strides whose last one is 1 — the natural projection output
`x.view(B, L, H, hd).transpose(1, 2)` and a head-leading tensor are both
read in place. On a CUDA device, bf16 q, k, v (and the backward's out
and dout) need a 16-byte-aligned base and strides that are multiples of
8 elements, which every projection output and its views have; the
kernels' entry points refuse any other, and the wrappers raise. The output is (B, H, Lq, hd) laid out in memory as
(B, Lq, H, hd), so `out.transpose(1, 2).reshape(B, Lq, H * hd)` feeds the
output projection with no copy; the gradients dq, dk, dv take the same
natural layout. `attention_fwd(..., out_layout="head")` writes a
contiguous head-leading (B, H, Lq, hd) output instead. The bias, when
given, is fp32 and broadcastable to (B, Lq, Lk) (a 4-D bias must have a
head dim of 1): it is shared by all heads, and broadcast dims are read
with stride 0.

Attention-prob dropout (training): the normalised probabilities are
dropped, ctx = dropout(softmax(q.k^T * s + bias)) . v, with the keep bit
of each logical (b, h, q, k) drawn by Philox4x32-10 from a device int64
pair {seed, offset} (`draw_seed_offset`, from the caller's
torch.Generator). `dropout_keep_mask` computes the kernels' bits with
int64 tensor arithmetic, so the plain versions drop exactly what the
kernels drop. Under tensor parallelism a rank holds heads `head_base ..
head_base + H - 1` of a layer's `heads_total`, and every function here
that drops takes the two: its mask is then that slice of the layer's one
global mask (the defaults, 0 and H, give the one-process mask).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from etpnav_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head widths each kernel is built for: 64 (ETPNav's heads) everywhere;
# K-ATT also at 192 (DeepSeek-V2's MLA), bf16 without dropout
_HEAD_DIMS = (64,)
_FWD_HEAD_DIMS = (64, 192)
_OUT_LAYOUTS = ("natural", "head")

#: launches of the CUDA kernels (wrappers) and calls of the plain versions
attention_fwd_launches = cuda_build.LaunchCounter()
attention_plain_calls = cuda_build.LaunchCounter()
#: K-ATT launches with `out_layout="head"` (counted here, not above)
attention_fwd_head_out_launches = cuda_build.LaunchCounter()
attention_cheap_launches = cuda_build.LaunchCounter()
attention_cheap_plain_calls = cuda_build.LaunchCounter()
attention_bwd_launches = cuda_build.LaunchCounter()
attention_bwd_plain_calls = cuda_build.LaunchCounter()

# Philox4x32-10 constants (csrc/philox.cuh)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _bind(lib: ctypes.CDLL) -> None:
    i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    lib.etp_attention_fwd.argtypes = (
        [vp] * 5 + [i32] * 6 + [i64] * 15
        + [ctypes.c_float, vp, ctypes.c_uint, ctypes.c_float, i32, i32, vp,
           vp])
    lib.etp_attention_fwd.restype = ctypes.c_int
    lib.etp_attention_cheap.argtypes = (
        [vp] * 4 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, vp])
    lib.etp_attention_cheap.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    i32, vp = ctypes.c_int, ctypes.c_void_p
    lib.etp_attention_bwd.argtypes = (
        [vp] * 11 + [i32] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, vp,
           ctypes.c_uint, ctypes.c_float, i32, i32, vp])
    lib.etp_attention_bwd.restype = ctypes.c_int
    lib.etp_attention_bwd_max_lk.argtypes = [i32] * 3
    lib.etp_attention_bwd_max_lk.restype = ctypes.c_int


cuda_build.register_binder("attention", _bind)
cuda_build.register_binder("attention_bwd", _bind_bwd)


def _bias_3d(bias: torch.Tensor, B: int, Lq: int, Lk: int) -> torch.Tensor:
    """Head-shared bias as a (B, Lq, Lk) fp32 view (broadcast dims get
    stride 0; nothing is copied for an fp32 bias)."""
    if bias.dim() == 4:
        if bias.shape[1] != 1:
            raise ValueError(f"bias {tuple(bias.shape)} is not head-shared")
        bias = bias[:, 0]
    return bias.float().expand(B, Lq, Lk)


# ---------------------------------------------------------------------------
# dropout bits
# ---------------------------------------------------------------------------

def _check_heads(H: int, head_base: int, heads_total: Optional[int]) -> int:
    """heads_total (H when None), checked to hold heads head_base ..
    head_base + H - 1."""
    heads_total = H if heads_total is None else int(heads_total)
    if not 0 <= head_base <= heads_total - H:
        raise ValueError(f"heads {head_base}..{head_base + H - 1} outside "
                         f"the layer's {heads_total}")
    return heads_total


def draw_seed_offset(generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """{seed, offset} of one attention call's dropout mask, as an int64[2]
    tensor on `device`, drawn from `generator` (on its own device, so a
    CUDA generator hands the kernel its seed without a host round trip)."""
    so = torch.randint(0, 2 ** 62, (2,), generator=generator,
                       device=generator.device, dtype=torch.int64)
    return so.to(device, non_blocking=True)


def _threshold(p_drop: float) -> Tuple[int, float]:
    """(the uint32 threshold below which a Philox word keeps its element,
    1 / keep)."""
    keep = 1.0 - p_drop
    return min(int(keep * 2.0 ** 32), _MASK32), 1.0 / keep


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product a * m, for a < 2^32
    in int64 and a 32-bit constant m: the product is split at 16 bits of
    m so no intermediate reaches 2^63."""
    u = a * (m >> 16)                      # < 2^48
    t = a * (m & 0xFFFF)                   # < 2^48
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _MASK32
    return hi, lo


def dropout_keep_mask(seed_offset: torch.Tensor, B: int, H: int, Lq: int,
                      Lk: int, p_drop: float,
                      device: Optional[torch.device] = None,
                      head_base: int = 0,
                      heads_total: Optional[int] = None) -> torch.Tensor:
    """The kernels' keep bits, (B, H, Lq, Lk) bool: element (b, h, q, k)
    is kept iff word k % 4 of Philox4x32-10 at counter (k // 4, q,
    b * heads_total + head_base + h, offset) under key (seed low, seed
    high) is below floor(keep * 2^32) (one call draws four consecutive
    keys). heads_total defaults to H."""
    heads_total = _check_heads(H, head_base, heads_total)
    device = seed_offset.device if device is None else device
    so = seed_offset.to(device=device, dtype=torch.int64)
    k0, k1 = so[0] & _MASK32, (so[0] >> 32) & _MASK32
    word = torch.arange(Lk, device=device).view(1, 1, 1, Lk) % 4
    c0 = torch.arange(Lk, device=device).view(1, 1, 1, Lk) // 4
    c1 = torch.arange(Lq, device=device).view(1, 1, Lq, 1)
    c2 = (torch.arange(B, device=device).view(B, 1, 1, 1) * heads_total
          + head_base + torch.arange(H, device=device).view(1, H, 1, 1))
    c3 = so[1] & _MASK32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    threshold, _ = _threshold(p_drop)
    bits = torch.where(word < 2, torch.where(word == 0, c0, c1),
                       torch.where(word == 2, c2, c3))
    return bits.expand(B, H, Lq, Lk) < threshold


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _check_layout(out_layout: str) -> None:
    if out_layout not in _OUT_LAYOUTS:
        raise ValueError(f"out_layout {out_layout!r} not in {_OUT_LAYOUTS}")


def _empty_out(q: torch.Tensor, out_layout: str) -> torch.Tensor:
    """An uninitialised (B, H, Lq, hd) output laid out in memory as
    (B, Lq, H, hd) ("natural") or (B, H, Lq, hd) ("head")."""
    B, H, Lq, hd = q.shape
    if out_layout == "head":
        return torch.empty(B, H, Lq, hd, dtype=q.dtype, device=q.device)
    return torch.empty(B, Lq, H, hd, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], scale: float,
                    p_drop: float = 0.0,
                    seed_offset: Optional[torch.Tensor] = None,
                    return_lse: bool = False, out_layout: str = "natural",
                    head_base: int = 0, heads_total: Optional[int] = None):
    """The plain PyTorch version of K-ATT, with the kernel's numerics:
    fp32 logits, max and sum; unnormalised p rounded to the input dtype
    before p.v (fp32 accumulation), a dropped p zeroed and a kept one
    scaled by 1/keep; the division by the sum (of every key) last. With
    `out_layout="head"` the output is contiguous, as the kernel's; the
    natural case keeps the strides the arithmetic gives. With
    `return_lse`, also the fp32 row log-sum-exp (B, H, Lq)."""
    _check_layout(out_layout)
    attention_plain_calls.add()
    res = softmax_attention(q, k, v, bias, scale, p_drop, seed_offset,
                            return_lse, head_base, heads_total)
    if out_layout == "natural":
        return res
    out = (res[0] if return_lse else res).contiguous()
    return (out, res[1]) if return_lse else out


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor], scale: float,
                      p_drop: float = 0.0,
                      seed_offset: Optional[torch.Tensor] = None,
                      return_lse: bool = False, head_base: int = 0,
                      heads_total: Optional[int] = None):
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
    pr = p.to(q.dtype).float()
    if seed_offset is not None:
        _, inv_keep = _threshold(p_drop)
        keep = dropout_keep_mask(seed_offset, B, H, Lq, Lk, p_drop, q.device,
                                 head_base, heads_total)
        pr = torch.where(keep, pr * inv_keep, 0.0)
    ctx = torch.einsum("bhqk,bhkd->bhqd", pr, v.float())
    out = (ctx / denom).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(denom > 0, m + torch.log(denom),
                      torch.full_like(m, float("inf")))[..., 0]
    return out, lse


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 `x` rounded to `dtype` and back (unchanged for fp32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, scale: float,
                        p_drop: float = 0.0,
                        seed_offset: Optional[torch.Tensor] = None,
                        bias_grad: bool = False, head_base: int = 0,
                        heads_total: Optional[int] = None):
    """The plain PyTorch version of K-ATT-BWD, with the kernel's numerics:
    P rebuilt in fp32 from the logits and the forward's lse, every sum in
    fp32. In bf16 the kernel's tensor cores take P o Z (through the
    rounded P) and dS rounded to bf16 into the dV, dK and dQ products,
    and so does this version; dP, D, dS itself and d(bias) stay fp32, and
    fp32 inputs are not rounded. Returns (dq, dk, dv) in q's dtype and
    d(bias) as fp32 (B, Lq, Lk), the head sum of dS, or None."""
    attention_bwd_plain_calls.add()
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.float()
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if bias is not None:
        logits = logits + _bias_3d(bias, B, Lq, Lk)[:, None]
    p = torch.exp(logits - lse[..., None])
    z = 1.0
    if seed_offset is not None:
        _, inv_keep = _threshold(p_drop)
        keep = dropout_keep_mask(seed_offset, B, H, Lq, Lk, p_drop, q.device,
                                 head_base, heads_total)
        z = torch.where(keep, inv_keep, 0.0)
    row_d = (dof * out.float()).sum(-1, keepdim=True)
    dpd = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dpd * z - row_d)
    dsr = _round_to(ds, q.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", _round_to(p, q.dtype) * z, dof)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsr, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qf) * scale
    dbias = ds.sum(1) if bias_grad else None
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_qkv(what: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, head_dims=_HEAD_DIMS) -> None:
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported")
    if hd not in head_dims:
        raise ValueError(f"{what}: head dim {hd} not supported "
                         f"(built for {head_dims})")
    for name, t, want in (("k", k, (B, H, Lk, hd)), ("v", v, (B, H, Lk, hd))):
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"{want}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{what}: {name} head dim not contiguous")
    if Lq < 1 or Lk < 1:
        raise ValueError(f"{what}: empty sequence")


# what the bf16 entry points return, without launching, for an operand
# whose rows are not 16-byte aligned (etp::kErrMisaligned, attention_tc.cuh)
_MISALIGNED = -2


def _check_status(err: int, what: str) -> None:
    """Raises for an entry point's nonzero status: ValueError for a bf16
    operand the kernel refused as not 16-byte aligned, RuntimeError for a
    failed launch."""
    if err == _MISALIGNED:
        raise ValueError(f"{what}: a bf16 operand is not 16-byte aligned "
                         "(its base, or a batch, head or row stride that is "
                         "not a multiple of 8 elements)")
    cuda_build.check(err, what)


def _bias_operand(what: str, bias: Optional[torch.Tensor], q: torch.Tensor,
                  Lk: int):
    """(pointer, (b, q, k) strides, the fp32 view kept alive) of a bias."""
    if bias is None:
        return None, (0, 0, 0), None
    if bias.device != q.device:
        raise ValueError(f"{what}: bias on another device")
    B, _, Lq, _ = q.shape
    b3 = _bias_3d(bias, B, Lq, Lk)
    return b3.data_ptr(), b3.stride(), b3


def _dropout_operand(what: str, p_drop: float,
                     seed_offset: Optional[torch.Tensor],
                     device: torch.device):
    """(pointer, threshold, 1/keep) of the dropout operands."""
    if seed_offset is None:
        return None, 0, 1.0
    if not 0.0 < p_drop < 1.0:
        raise ValueError(f"{what}: p_drop {p_drop} outside (0, 1)")
    if (seed_offset.device != device or seed_offset.dtype != torch.int64
            or seed_offset.numel() != 2 or not seed_offset.is_contiguous()):
        raise ValueError(f"{what}: seed_offset must be a contiguous int64[2]"
                         f" on {device}")
    threshold, inv_keep = _threshold(p_drop)
    return seed_offset.data_ptr(), threshold, inv_keep


def _cuda(what: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return True


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], scale: float,
                  p_drop: float = 0.0,
                  seed_offset: Optional[torch.Tensor] = None,
                  return_lse: bool = False, out_layout: str = "natural",
                  head_base: int = 0, heads_total: Optional[int] = None):
    """softmax(q.k^T * scale + bias) . v per head, with attention-prob
    dropout when `seed_offset` is given (the heads being `head_base ..` of
    the layer's `heads_total`). The (B, H, Lq, hd) output lies in
    memory as (B, Lq, H, hd) with `out_layout="natural"`, or contiguous
    with `"head"`. CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise. With `return_lse`, returns (out, fp32 row
    log-sum-exp (B, H, Lq))."""
    _check_layout(out_layout)
    if not _cuda("attention_fwd", q):
        return attention_plain(q, k, v, bias, scale, p_drop, seed_offset,
                               return_lse, out_layout, head_base,
                               heads_total)
    _check_qkv("attention_fwd", q, k, v, _FWD_HEAD_DIMS)
    B, H, Lq, hd = q.shape
    if hd != 64 and (q.dtype != torch.bfloat16 or seed_offset is not None):
        raise ValueError(f"attention_fwd: head dim {hd} is built for bf16 "
                         "without dropout only")
    heads_total = _check_heads(H, head_base, heads_total)
    Lk = k.shape[2]
    bias_ptr, sb, _keep_alive = _bias_operand("attention_fwd", bias, q, Lk)
    seed_ptr, threshold, inv_keep = _dropout_operand(
        "attention_fwd", p_drop, seed_offset, q.device)
    out = _empty_out(q, out_layout)
    lse =(torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = cuda_build.load("attention")
    sq, sk, sv, so = q.stride(), k.stride(), v.stride(), out.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.etp_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), _DTYPES[q.dtype], B, H, Lq, Lk, hd,
            sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2],
            so[0], so[1], so[2], sb[0], sb[1], sb[2], float(scale),
            seed_ptr, threshold, inv_keep, heads_total, head_base,
            None if lse is None else lse.data_ptr(), stream)
    _check_status(err, "attention_fwd")
    if out_layout == "head":
        attention_fwd_head_out_launches.add()
    else:
        attention_fwd_launches.add()
    return (out, lse) if return_lse else out


def _check_cheap(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"attention_cheap: q must be (B, H, Lq, hd), got "
                         f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"attention_cheap: {name} is {t.dtype}; "
                             "K-ATT-CHEAP takes bfloat16 only")


def attention_cheap_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain PyTorch version of K-ATT-CHEAP (bf16), with the kernel's
    and the TPU tool's rounding points: logits = bf16(fp32 sum of q.k),
    times bf16(scale) and minus 10 in bf16, p = bf16(exp(fp32)); the sum
    and p.v in fp32; out = bf16(ctx / sum). No max is subtracted."""
    _check_cheap(q, k, v)
    attention_cheap_plain_calls.add()
    bf = torch.bfloat16
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()).to(bf)
    logits = logits * torch.tensor(scale, dtype=bf)
    logits = logits - torch.tensor(10.0, dtype=bf)
    p = torch.exp(logits.float()).to(bf).float()
    ctx = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return (ctx / p.sum(-1, keepdim=True)).to(bf)


def attention_cheap(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Unbiased attention with bf16 logits and a constant-shift softmax
    (`attention_cheap_plain` gives its arithmetic), q (B, H, Lq, hd), k
    and v (B, H, Lk, hd) bf16 in any strides with a contiguous head dim;
    returns a contiguous (B, H, Lq, hd). This is the TPU kernel's pack = 1
    function: its `pack` only put samples into one 128x128 matrix tile,
    and the cross blocks' weights (e^-40 each) stay below one bf16 ulp of
    the output, so it has no counterpart here. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    _check_cheap(q, k, v)
    if not _cuda("attention_cheap", q):
        return attention_cheap_plain(q, k, v, scale)
    _check_qkv("attention_cheap", q, k, v)
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    out = _empty_out(q, "head")
    lib = cuda_build.load("attention")
    sq, sk, sv, so = q.stride(), k.stride(), v.stride(), out.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.etp_attention_cheap(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Lq, Lk, hd, sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0],
            sv[1], sv[2], so[0], so[1], so[2], float(scale), stream)
    _check_status(err, "attention_cheap")
    attention_cheap_launches.add()
    return out


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, scale: float,
                  p_drop: float = 0.0,
                  seed_offset: Optional[torch.Tensor] = None,
                  bias_grad: bool = False, head_base: int = 0,
                  heads_total: Optional[int] = None):
    """The gradients of `attention_fwd` given dL/d(out): (dq, dk, dv) in
    q's dtype and d(bias) as fp32 (B, Lq, Lk) or None. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if not _cuda("attention_bwd", q):
        return attention_bwd_plain(q, k, v, bias, out, lse, dout, scale,
                                   p_drop, seed_offset, bias_grad, head_base,
                                   heads_total)
    _check_qkv("attention_bwd", q, k, v)
    B, H, Lq, hd = q.shape
    heads_total = _check_heads(H, head_base, heads_total)
    Lk = k.shape[2]
    lib = cuda_build.load("attention_bwd")
    max_lk = lib.etp_attention_bwd_max_lk(_DTYPES[q.dtype], Lq,
                                          int(bias_grad))
    if Lk > max_lk:
        raise ValueError(f"attention_bwd: Lk {Lk} > {max_lk}, the most its "
                         f"shared memory holds at Lq {Lq}")
    for name, t in (("out", out), ("dout", dout)):
        if (tuple(t.shape) != (B, H, Lq, hd) or t.dtype != q.dtype
                or t.device != q.device or t.stride(3) != 1):
            raise ValueError(f"attention_bwd: {name} must be {q.dtype} "
                             f"(B, H, Lq, hd) on {q.device} with a "
                             "contiguous head dim")
    if (tuple(lse.shape) != (B, H, Lq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("attention_bwd: lse must be contiguous fp32 "
                         "(B, H, Lq)")
    bias_ptr, sb, _keep_alive = _bias_operand("attention_bwd", bias, q, Lk)
    seed_ptr, threshold, inv_keep = _dropout_operand(
        "attention_bwd", p_drop, seed_offset, q.device)

    def natural(L):
        return torch.empty(B, L, H, hd, dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    dq, dk, dv = natural(Lq), natural(Lk), natural(Lk)
    dbias = (torch.empty(B, Lq, Lk, dtype=torch.float32, device=q.device)
             if bias_grad else None)
    strides = [s for t in (q, k, v, out, dout, dq, dk, dv)
               for s in t.stride()[:3]] + list(sb)
    st = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.etp_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if dbias is None else dbias.data_ptr(),
            _DTYPES[q.dtype], B, H, Lq, Lk, hd, st, float(scale), seed_ptr,
            threshold, inv_keep, heads_total, head_base, stream)
    _check_status(err, "attention_bwd")
    attention_bwd_launches.add()
    return dq, dk, dv, dbias


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class AttentionFn(torch.autograd.Function):
    """K-ATT forward, K-ATT-BWD backward (each its plain version on CPU
    tensors). Saves q, k, v, the bias, the output, the fp32 row lse and
    the dropout seed; d(bias) is returned only when the bias requires
    grad, summed to the bias's broadcast shape."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, p_drop: float,
                seed_offset, head_base: int = 0,
                heads_total: Optional[int] = None):
        out, lse = attention_fwd(q, k, v, bias, scale, p_drop, seed_offset,
                                 return_lse=True, head_base=head_base,
                                 heads_total=heads_total)
        ctx.save_for_backward(q, k, v, bias, out, lse, seed_offset)
        ctx.scale, ctx.p_drop = scale, p_drop
        ctx.heads = (head_base, heads_total)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse, seed_offset = ctx.saved_tensors
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = attention_bwd(
            q, k, v, bias, out, lse, dout, ctx.scale, ctx.p_drop,
            seed_offset, bias_grad, head_base=ctx.heads[0],
            heads_total=ctx.heads[1])
        if bias_grad:
            if bias.dim() == 4:
                dbias = dbias[:, None]
            dbias = dbias.sum_to_size(bias.shape).to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], scale: float,
              p_drop: float = 0.0,
              generator: Optional[torch.Generator] = None,
              head_base: int = 0,
              heads_total: Optional[int] = None) -> torch.Tensor:
    """The attention of every port module, with dropout at `p_drop` when a
    generator is given (one {seed, offset} drawn per call), none
    otherwise; q's heads are `head_base ..` of the layer's `heads_total`.
    Where autograd records, it runs `AttentionFn`; elsewhere (serving,
    the rollout) the forward kernel alone, with no lse."""
    seed_offset = None
    if p_drop > 0.0 and generator is not None:
        seed_offset = draw_seed_offset(generator, q.device)
    else:
        p_drop = 0.0
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias))):
        return attention_fwd(q, k, v, bias, scale, p_drop, seed_offset,
                             head_base=head_base, heads_total=heads_total)
    return AttentionFn.apply(q, k, v, bias, float(scale), p_drop,
                             seed_offset, head_base, heads_total)
