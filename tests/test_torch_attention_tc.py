"""The bf16 rounding points of K-ATT and K-ATT-BWD, whose bf16 kernels run
on tensor cores (mma.sync), held on the CPU through their plain versions
against the JAX package, and the kernels' sources.

Both sides get the same numpy inputs from a seeded generator, rounded to
bf16, at hd = 64 and L <= 24. The JAX side runs the Pallas
`fused_bias_attention` in interpret mode (its backward is its custom VJP,
XLA's VJP of `_attention_xla`), compiled with `xla_allow_excess_precision`
off, or XLA on the CPU keeps fp32 between bf16 elementwise ops and skips
the roundings the kernels write. chip_smoke.py holds the CUDA kernels to
these plain versions on the GPU.

Tolerances (bf16 ulp = the spacing at the largest value of the result):
- forward: one ulp. Both round the unnormalised p at the row max before
  p.v and divide last; their fp32 sums run in another order, so an output
  next to a rounding tie may land one ulp apart.
- dv: one ulp. Both round the normalised p to bf16 before (P o Z)^T . dO.
- dq, dk: two ulps. The port rounds dS to bf16 before dS . K and
  dS^T . Q (the tensor cores' A operand), XLA rounds dP = dO . V^T to bf16
  and keeps dS fp32; each rounds an O(1) share of its terms by up to half
  an ulp of that term (one ulp of the largest gradient seen).
- d(bias): 1e-2 of the largest. Both sum fp32 dS over the heads, but
  XLA's dS carries dP rounded to bf16 (2^-9 relative per element) and its
  row term sum_k dP p where the port takes rowsum(dO o O).
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etpnav_tpu.ops.pallas_attention import fused_bias_attention
from etpnav_tpu_torch.ops import fused_attention as tfa

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, H, LQ, LK, HD = 2, 3, 24, 20, 64
SCALE = 1.0 / math.sqrt(HD)
DBIAS_REL = 1e-2


def strict(fn, *args):
    """fn(*args) compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def bf16_ulp(a: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(np.abs(a).max())) - 7)


def case(seed: int, bias_kind: str):
    """bf16 q, k, v, dout (torch) and the (B, Lq, Lk) fp32 bias (numpy;
    zeros for "none", a padding mask plus noise for "full")."""
    rng = np.random.default_rng(seed)
    qkvd = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16)
            for s in ((B, H, LQ, HD), (B, H, LK, HD), (B, H, LK, HD),
                      (B, H, LQ, HD))]
    bias = np.zeros((B, LQ, LK), np.float32)
    if bias_kind == "full":
        keep = np.arange(LK)[None] < np.array([[LK], [13]])
        bias = (np.where(keep, 0.0, -10000.0)[:, None, :]
                + rng.standard_normal((B, LQ, LK))).astype(np.float32)
    return qkvd, bias


def jax_side(qkvd, bias):
    """(out, dq, dk, dv, dbias) of the Pallas kernel and its VJP, fp32."""
    q, k, v, do = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in qkvd)

    def f(q, k, v, bias, do):
        out, vjp = jax.vjp(
            lambda *a: fused_bias_attention(*a, SCALE, True), q, k, v, bias)
        return (out,) + vjp(do)

    return [np.asarray(x.astype(jnp.float32))
            for x in strict(f, q, k, v, jnp.asarray(bias), do)]


@pytest.mark.parametrize("bias_kind", ["full", "none"])
def test_attention_plain_bf16_matches_pallas(bias_kind):
    (q, k, v, _), bias = case(1, bias_kind)
    want = jax_side((q, k, v, q), bias)[0]
    got = tfa.attention_plain(
        q, k, v, torch.from_numpy(bias) if bias_kind == "full" else None,
        SCALE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=bf16_ulp(want))


@pytest.mark.parametrize("bias_kind", ["full", "none"])
def test_attention_bwd_plain_bf16_matches_jax_vjp(bias_kind):
    (q, k, v, dout), bias = case(2, bias_kind)
    want = jax_side((q, k, v, dout), bias)
    tbias = torch.from_numpy(bias) if bias_kind == "full" else None
    out, lse = tfa.attention_plain(q, k, v, tbias, SCALE, return_lse=True)
    dq, dk, dv, dbias = tfa.attention_bwd_plain(
        q, k, v, tbias, out, lse, dout, SCALE, bias_grad=tbias is not None)
    for name, got, w, ulps in (("dq", dq, want[1], 2), ("dk", dk, want[2], 2),
                               ("dv", dv, want[3], 1)):
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(got.float().numpy(), w,
                                   atol=ulps * bf16_ulp(w), err_msg=name)
    if tbias is None:
        assert dbias is None
    else:
        assert dbias.dtype == torch.float32
        np.testing.assert_allclose(dbias.numpy(), want[4],
                                   atol=DBIAS_REL * np.abs(want[4]).max())


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_attention_bwd_plain_bf16_rounding_points(p_drop):
    """In bf16 the plain backward rounds P o Z (through P) and dS to bf16
    before the products, as the tensor cores take them, and nothing else:
    it matches float64 products of exactly those rounded operands within
    one ulp of the result's final rounding. fp32 inputs are not rounded."""
    (q, k, v, dout), bias = case(3, "full")
    tbias = torch.from_numpy(bias)
    so = (tfa.draw_seed_offset(torch.Generator().manual_seed(4),
                               torch.device("cpu")) if p_drop else None)
    out, lse = tfa.attention_plain(q, k, v, tbias, SCALE, p_drop, so,
                                   return_lse=True)
    got = tfa.attention_bwd_plain(q, k, v, tbias, out, lse, dout, SCALE,
                                  p_drop, so, bias_grad=True)

    qd, kd, vd, dod = (t.double() for t in (q, k, v, dout))
    logits = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * SCALE
              + tbias[:, None])
    p = torch.exp(logits - lse[..., None]).double()
    z = torch.ones(())
    if so is not None:
        keep = tfa.dropout_keep_mask(so, B, H, LQ, LK, p_drop)
        z = torch.where(keep, 1.0 / (1.0 - p_drop), 0.0)
    z = z.double()
    dp = torch.einsum("bhqd,bhkd->bhqk", dod, vd)
    row_d = (dod * out.double()).sum(-1, keepdim=True)
    ds = p * (dp * z - row_d)
    ds_r = ds.float().to(torch.bfloat16).double()
    p_r = p.float().to(torch.bfloat16).double()
    want = (torch.einsum("bhqk,bhkd->bhqd", ds_r, kd) * SCALE,
            torch.einsum("bhqk,bhqd->bhkd", ds_r, qd) * SCALE,
            torch.einsum("bhqk,bhqd->bhkd", p_r * z, dod))
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want):
        np.testing.assert_allclose(g.double().numpy(), w.numpy(),
                                   atol=bf16_ulp(w.numpy()), err_msg=name)
    # d(bias) is the fp32 head sum of the unrounded dS
    np.testing.assert_allclose(got[3].double().numpy(), ds.sum(1).numpy(),
                               atol=1e-5 * ds.abs().max().item())
    # fp32 inputs: no rounding point at all
    f32 = [t.float() for t in (q, k, v, out, dout)]
    got32 = tfa.attention_bwd_plain(f32[0], f32[1], f32[2], tbias, f32[3],
                                    lse, f32[4], SCALE, p_drop, so)
    want32 = torch.einsum("bhqk,bhkd->bhqd", ds, kd) * SCALE
    np.testing.assert_allclose(got32[0].double().numpy(), want32.numpy(),
                               atol=1e-5 * want32.abs().max().item())


def _code(*names: str) -> str:
    """The listed csrc files with their // comments removed."""
    src = "\n".join((ROOT / "etpnav_tpu_torch/csrc" / n).read_text()
                    for n in names)
    return "\n".join(line.split("//")[0] for line in src.splitlines())


@pytest.mark.parametrize("source", ["attention.cu", "attention_bwd.cu"])
def test_bf16_attention_kernels_issue_mma_and_no_library(source):
    """The bf16 kernels of K-ATT (with K-ATT-CHEAP) and K-ATT-BWD compute
    their products with mma.sync, through the tile helpers they include,
    and name no cuBLAS, cuDNN or SDPA symbol."""
    src = (ROOT / "etpnav_tpu_torch/csrc" / source).read_text()
    assert '#include "attention_tc.cuh"' in src
    code = _code(source, "attention_tc.cuh", "dense.cuh")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
    assert "ldmatrix.sync.aligned" in code and "cp.async" in code
    kernel = "attention_bwd_tc_kernel" if "bwd" in source else \
        "attention_fwd_tc_kernel"
    body = code[code.index(f"{kernel}("):]
    assert "etp::mma_bf16(" in body
    lowered = code.lower()
    for name in ("cublas", "cudnn", "scaled_dot_product", "flash_attn"):
        assert name not in lowered, name


def test_bf16_wrappers_check_16_byte_rows():
    """The bf16 kernels copy and store 16-byte rows. Their entry points
    test every bf16 operand's base and strides (etp::rows16) before the
    launch and return kErrMisaligned, which the wrappers raise as
    ValueError; any other nonzero status is a failed launch. chip_smoke.py
    checks the refusal on the card."""
    tc = _code("attention_tc.cuh")
    assert f"kErrMisaligned = {tfa._MISALIGNED};" in tc
    assert "% 16 == 0" in tc and "s.l % 8 == 0" in tc
    fwd = _code("attention.cu")
    launch = fwd[fwd.index("int launch_tc("):]
    bwd = _code("attention_bwd.cu")
    entry = bwd[bwd.index("int etp_attention_bwd("):]
    for body, ops, launched in (
            (launch, ("q, sq", "k, sk", "v, sv", "out, so"), "<<<"),
            (entry, ("q, sq", "k, sk", "v, sv", "o, so", "dout, sdo"),
             "attention_bwd_tc_kernel")):
        for op in ops:
            assert f"etp::rows16({op}," in body, op
        assert (body.index("return etp::kErrMisaligned")
                < body.index(launched))
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_status(tfa._MISALIGNED, "t")
    with pytest.raises(RuntimeError, match="error 700"):
        tfa._check_status(700, "t")
    tfa._check_status(0, "t")
