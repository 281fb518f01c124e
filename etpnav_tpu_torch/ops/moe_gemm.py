"""K-MOE: the grouped expert products of a mixture-of-experts layer,
their wrappers and their plain versions (a kernel of the port only: the
JAX package has no expert layer).

The caller sorts a layer's token-expert routings by the expert that
computes them (`models/dsv2_text.py::moe`): row r of `x` is the token of
the r-th routing, and the rows of held expert e are offsets[e] ..
offsets[e + 1] - 1; rows past offsets[E] are routings to experts held
elsewhere, which no product reads into a stored result. Two launches:

- `moe_gate_up(x, w_gu, offsets)`: h[r] = bf16(silu(g) * u), [g, u] =
  x[r] . w_gu[e]^T in fp32 (w_gu (E, 2I, K): expert e's gate rows, then
  its up rows);
- `moe_down(h, w_d, offsets, row_w, dest, n_dest)`: y[dest[r]] =
  row_w[r] * (h[r] . w_d[e]^T) in fp32, into a zeroed (n_dest, N) y, so
  the rows of other experts' routings stay 0 and the caller sums a
  token's routings with no atomics.

The CUDA source, `csrc/moe_gemm.cu`, says what bounds the products on an
H100 and what its design does about it. CUDA tensors launch it or
raise; CPU tensors run the plain versions, which loop over the experts.
bf16 on the card only.
"""

from __future__ import annotations

import ctypes

import torch

from etpnav_tpu_torch.ops import cuda_build

#: launches of the two CUDA kernels and calls of the plain versions
moe_gate_up_launches = cuda_build.LaunchCounter()
moe_down_launches = cuda_build.LaunchCounter()
moe_plain_calls = cuda_build.LaunchCounter()

# the kernels' tiles: 64 weight rows a warpgroup, 64 routing rows, k-slabs
# of 64 (csrc/moe_gemm.cu)
_TILE = 64


def _bind(lib: ctypes.CDLL) -> None:
    i32, vp = ctypes.c_int, ctypes.c_void_p
    lib.etp_moe_gate_up.argtypes = [vp] * 4 + [i32] * 4 + [vp]
    lib.etp_moe_gate_up.restype = ctypes.c_int
    lib.etp_moe_down.argtypes = [vp] * 6 + [i32] * 4 + [vp]
    lib.etp_moe_down.restype = ctypes.c_int
    cuda_build.bind_dense_fault(lib)


cuda_build.register_binder("moe_gemm", _bind)


def _groups(offsets: torch.Tensor):
    off = offsets.tolist()
    return [(e, off[e], off[e + 1]) for e in range(len(off) - 1)
            if off[e + 1] > off[e]]


def moe_gate_up_plain(x: torch.Tensor, w_gu: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """The plain version of `moe_gate_up`, with the kernel's numerics: the
    products in fp32 (of the operands as given), silu(g) * u in fp32,
    one rounding to x's dtype. Rows past offsets[E] are 0."""
    moe_plain_calls.add()
    inter = w_gu.shape[1] // 2
    out = torch.zeros(x.shape[0], inter, dtype=x.dtype, device=x.device)
    for e, a, b in _groups(offsets):
        gu = x[a:b].float() @ w_gu[e].float().t()
        out[a:b] = (torch.nn.functional.silu(gu[:, :inter])
                    * gu[:, inter:]).to(x.dtype)
    return out


def moe_down_plain(h: torch.Tensor, w_d: torch.Tensor,
                   offsets: torch.Tensor, row_w: torch.Tensor,
                   dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """The plain version of `moe_down`: fp32 products, times the fp32
    routing weight, scattered to the rows `dest`."""
    moe_plain_calls.add()
    out = torch.zeros(n_dest, w_d.shape[1], dtype=torch.float32,
                      device=h.device)
    for e, a, b in _groups(offsets):
        out[dest[a:b].long()] = row_w[a:b, None] * (
            h[a:b].float() @ w_d[e].float().t())
    return out


def _check(what: str, x, w, offsets, n_out: int) -> None:
    E, _, K = w.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{what}: bf16 operands only on the card, got "
                         f"{x.dtype} and {w.dtype}")
    if x.dim() != 2 or x.shape[1] != K or not x.is_contiguous() \
            or not w.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be contiguous (R, K) and "
                         "(E, N, K)")
    if K % _TILE or n_out % (2 * _TILE):
        raise ValueError(f"{what}: K {K} and the output width {n_out} must "
                         f"be multiples of {_TILE} and {2 * _TILE}")
    if (offsets.dtype != torch.int32 or tuple(offsets.shape) != (E + 1,)
            or not offsets.is_contiguous()):
        raise ValueError(f"{what}: offsets must be contiguous int32 "
                         f"(E + 1,)")
    for t in (w, offsets):
        if t.device != x.device:
            raise ValueError(f"{what}: operands on different devices")


def _cuda(what: str, x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def moe_gate_up(x: torch.Tensor, w_gu: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """(R, K) sorted routing rows, (E, 2I, K) gate-then-up weights, int32
    (E + 1,) offsets -> (R, I) silu(gate) * up in x's dtype; rows past
    offsets[E] are left unwritten by the kernel (0 in the plain
    version)."""
    if not _cuda("moe_gate_up", x):
        return moe_gate_up_plain(x, w_gu, offsets)
    E, two_i, K = w_gu.shape
    _check("moe_gate_up", x, w_gu, offsets, two_i)
    R = x.shape[0]
    out = torch.empty(R, two_i // 2, dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    lib = cuda_build.load("moe_gemm")
    with torch.cuda.device(x.device):
        err = lib.etp_moe_gate_up(
            x.data_ptr(), w_gu.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), E, two_i // 2, K, R,
            torch.cuda.current_stream().cuda_stream)
    _status(err, "moe_gate_up")
    moe_gate_up_launches.add()
    return out


def moe_down(h: torch.Tensor, w_d: torch.Tensor, offsets: torch.Tensor,
             row_w: torch.Tensor, dest: torch.Tensor,
             n_dest: int) -> torch.Tensor:
    """(R, K) sorted rows, (E, N, K) weights, int32 (E + 1,) offsets,
    fp32 (R,) routing weights, int32 (R,) destination rows -> (n_dest,
    N) fp32: row dest[r] = row_w[r] * (h[r] . w_d[e]^T) for every row of
    a held expert, 0 elsewhere."""
    if not _cuda("moe_down", h):
        return moe_down_plain(h, w_d, offsets, row_w, dest, n_dest)
    E, N, K = w_d.shape
    _check("moe_down", h, w_d, offsets, N)
    R = h.shape[0]
    if (row_w.dtype != torch.float32 or dest.dtype != torch.int32
            or row_w.shape != (R,) or dest.shape != (R,)
            or not row_w.is_contiguous() or not dest.is_contiguous()):
        raise ValueError("moe_down: row_w fp32 (R,) and dest int32 (R,), "
                         "contiguous")
    out = torch.zeros(n_dest, N, dtype=torch.float32, device=h.device)
    if R == 0:
        return out
    lib = cuda_build.load("moe_gemm")
    with torch.cuda.device(h.device):
        err = lib.etp_moe_down(
            h.data_ptr(), w_d.data_ptr(), offsets.data_ptr(),
            row_w.data_ptr(), dest.data_ptr(), out.data_ptr(), E, N, K, R,
            torch.cuda.current_stream().cuda_stream)
    _status(err, "moe_down")
    moe_down_launches.add()
    return out


def _status(err: int, what: str) -> None:
    if err == -2:
        raise ValueError(f"{what}: an operand is not 16-byte aligned")
    cuda_build.check(err, what)

