"""The last three TPU kernels' ports against the JAX package, on the CPU:
K-BLOCK (`ops/fused_block.py`), K-ATT with a head-leading output and
K-ATT-CHEAP (`ops/fused_attention.py`), and the two experiment tools that
run them (`etpnav_tpu_torch/tools/`).

Both sides get the same numpy inputs from a seeded generator. The JAX
side runs the Pallas kernels in interpret mode: `fused_attention_block`
takes `interpret=True`; `bdims_attention` and `cheap_attention` are
nested in the `main()` of the unchanged `tools/exp_attn_*.py`, so their
definitions are taken from the source with `ast` and run with a
`pallas_call` that interprets. In bf16 the JAX side is compiled with
XLA's `xla_allow_excess_precision` off (`strict`): by default XLA on the
CPU keeps fp32 between consecutive bf16 elementwise ops, which skips
roundings the kernels' sources write (`cheap_attention`'s logits times
bf16(scale), minus bf16(10), then exp). The port runs on the CPU, where
each wrapper takes its plain version; chip_smoke.py holds the CUDA
kernels to those plain versions on the GPU.

Tolerances: K-BLOCK 3e-5 absolute in fp32 (tests/test_pallas_attention.py's
tolerance for the same kernel; LayerNorm outputs of magnitude ~3, fp32
sums in another order); K-ATT head-leading 1e-6 in fp32 (the same
formula, division last, on both sides) and one bf16 ulp at the largest
output in bf16; K-ATT-CHEAP one bf16 ulp at the largest output (both sides
round at the same points, but their fp32 sums run in another order, so an
output next to a rounding tie may land one ulp apart; with pack = 2 the
TPU kernel's cross blocks also add e^-40-weighted terms to the sums, so
pack = 2 is not bit-exact by construction even where pack = 1 is).
"""

import ast
import functools
import inspect
import math
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from etpnav_tpu.ops import attention as jattn
from etpnav_tpu.ops.basic import mask_to_bias as jax_mask_to_bias
from etpnav_tpu.ops.pallas_attention import fused_attention_block
from etpnav_tpu_torch.models.convert import load_jax_tree
from etpnav_tpu_torch.ops import fused_attention as tfa
from etpnav_tpu_torch.ops import fused_block as tfb
from etpnav_tpu_torch.ops.attention import AttentionBlock, \
    self_attention_block
from etpnav_tpu_torch.ops.basic import mask_to_bias
from etpnav_tpu_torch.tools import exp_attn_layout, exp_attn_pack

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL_BLOCK = 3e-5
ATOL_ATT = 1e-6
B, H, D = 2, 2, 128                     # K-BLOCK: hd 64


def random_jax_tree(init_fn, *args, seed=0):
    """The tree a JAX `*_init` function returns (structure and shapes from
    `jax.eval_shape`), filled with seeded numpy values: norm scales near
    1, biases ~0.1, every other array std 0.02."""
    shapes = jax.eval_shape(lambda k: init_fn(k, *args),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", None)
        z = rng.standard_normal(s.shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name in ("bias", "b"):
            z = 0.1 * z
        else:
            z = 0.02 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def block_case(L: int, seed: int = 0):
    """(JAX tree, the loaded AttentionBlock, x (B, L, D), key mask)."""
    tree = random_jax_tree(jattn.self_attention_block_init, D, seed=seed)
    params = AttentionBlock(D)
    load_jax_tree(params, tree)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[0, L * 2 // 3:] = False
    mask[1, L - 3:] = False
    return tree, params, x, mask


def port_bias(mask: np.ndarray) -> torch.Tensor:
    """The text encoder's key-mask bias, (B, 1, 1, L)."""
    return mask_to_bias(torch.from_numpy(mask))[:, None, None, :]


def strict(fn, *args):
    """fn(*args) compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


CASES = [(16, 1e-12), (24, 1e-5)]


@pytest.mark.parametrize("L,eps", CASES)
def test_block_plain_matches_pallas_interpret(L, eps):
    tree, params, x, mask = block_case(L)
    bias3 = jnp.broadcast_to(jax_mask_to_bias(jnp.asarray(mask))[:, None, :],
                             (B, L, L))
    want = fused_attention_block(jnp.asarray(x), tree, bias3, H, eps,
                                 interpret=True)
    with torch.no_grad():
        got = tfb.attention_block(torch.from_numpy(x), params,
                                  port_bias(mask), H, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_BLOCK)


@pytest.mark.parametrize("L,eps", CASES)
def test_block_plain_matches_jax_self_attention_block(L, eps):
    tree, params, x, mask = block_case(L, seed=3)
    want = jattn.self_attention_block(
        tree, jnp.asarray(x), H,
        jax_mask_to_bias(jnp.asarray(mask))[:, None, None, :], eps)
    with torch.no_grad():
        got = tfb.attention_block(torch.from_numpy(x), params,
                                  port_bias(mask), H, eps)
        unfused = self_attention_block(params, torch.from_numpy(x), H,
                                       port_bias(mask), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_BLOCK)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(),
                               atol=ATOL_BLOCK)


def test_block_bias_forms_agree():
    """The graph self-attention's (B, 1, L, L) mask + sprel bias against
    its (B, L, L) squeeze, and a (1, 1, 1, L) key mask against its
    broadcast (B, L, L) copy."""
    L = 16
    _, params, x, mask = block_case(L, seed=5)
    rng = np.random.default_rng(6)
    sprel = torch.from_numpy(-rng.random((B, L, L)).astype(np.float32))
    full = port_bias(mask) + sprel[:, None]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        a = tfb.attention_block(xt, params, full, H, 1e-12)
        b = tfb.attention_block(xt, params, full[:, 0].contiguous(), H,
                                1e-12)
        key = port_bias(mask[:1])
        c = tfb.attention_block(xt, params, key, H, 1e-12)
        d = tfb.attention_block(xt, params, key.expand(B, 1, L, L)[:, 0]
                                .contiguous(), H, 1e-12)
        ref = self_attention_block(params, xt, H, full, 1e-12)
    assert torch.equal(a, b)
    assert torch.equal(c, d)
    np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=ATOL_BLOCK)


def test_block_bf16_rounding_points():
    """In bf16 the plain version rounds where the Pallas kernel does: it
    matches the kernel in interpret mode within two bf16 ulps of the
    largest output (the fp32 sums run in another order)."""
    L, eps = 16, 1e-12
    tree, params, x, mask = block_case(L, seed=7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    bias3 = jnp.broadcast_to(jax_mask_to_bias(jnp.asarray(mask))[:, None, :],
                             (B, L, L))
    want = np.asarray(strict(
        lambda x: fused_attention_block(x, tree, bias3, H, eps,
                                        interpret=True),
        jnp.asarray(xb.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = tfb.attention_block(xb, params, port_bias(mask), H, eps)
    assert got.dtype == torch.bfloat16
    tol = 2 * 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)


def test_block_kernel_path_calls_no_library_gemm():
    """K-BLOCK's projections are the kernel's own: neither its CUDA
    source, nor the GEMM header it includes, nor its wrapper calls
    cuBLAS, torch.matmul or F.linear."""
    csrc = ROOT / "etpnav_tpu_torch/csrc"
    src = (csrc / "attention_block.cu").read_text()
    assert '#include "dense.cuh"' in src
    src += (csrc / "dense.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "cublas" not in code.lower()
    assert "mma.sync" in code
    wrapper = inspect.getsource(tfb.attention_block)
    for name in ("matmul", "linear", "einsum", "bmm", "@", "mm("):
        assert name not in wrapper, name


def test_bf16_gemm_is_wgmma_fed_by_tma():
    """The one bf16 GEMM of K-PRENORM and K-BLOCK (`dense.cuh`) issues
    `wgmma.mma_async` on shared-memory tiles that TMA
    (`cp.async.bulk.tensor`) loads and mbarriers signal, with descriptors
    in the 128-byte swizzle its tensor maps write; the bf16 branch of
    `launch_gemm` reaches it, and no line names cuBLAS."""
    dense = (ROOT / "etpnav_tpu_torch/csrc/dense.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in dense.splitlines())
    assert "cublas" not in code.lower()
    for ptx in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                "wgmma.fence.sync.aligned", "wgmma.commit_group.sync.aligned",
                "wgmma.wait_group.sync.aligned",
                "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier",
                "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                "mbarrier.init"):
        assert ptx in code, ptx
    def body(sig: str) -> str:
        text = code[code.index(sig):]
        return text[:text.index("\n}\n")]

    producer = body("void produce_tile(")
    for call in ("mbar_wait(&empty[s]", "mbar_expect_tx(&full[s]",
                 "tma_load_2d(st, tm_a", "tma_load_2d(st + Tile::kABytes"):
        assert call in producer, call
    consumer = body("void consume_tile(")
    for call in ("mbar_wait(&full[s]", "wgmma_tile<BN>(d,", "wgmma_commit()",
                 "wgmma_wait<1>()", "mbar_arrive(&empty["):
        assert call in consumer, call
    kernel = body("gemm_bf16_kernel(const __grid_constant__")
    assert "produce_tile<BM, BN, STAGES>(&tm_a, &tm_w" in kernel
    assert "consume_tile<BM, BN, STAGES>(d, base, full, empty" in kernel
    assert "mma_bf16(" not in kernel and "cp_async16" not in kernel
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in code and "(1ull << 62)" in code
    branch = code[code.index("int launch_gemm(const GemmArgs& p"):]
    branch = branch[:branch.index("} else {")]
    assert "dispatch_gemm_bf16<TO>(p, parts, st)" in branch
    tiles = code[code.index("int dispatch_gemm_bf16("):]
    assert "launch_gemm_bf16<TO, 128, 128, 3, 2>" in tiles
    assert "gemm_bf16_kernel<TO, BM, BN, STAGES, MIN_BLOCKS>" in code


def test_block_wrapper_cpu_routes_to_plain():
    _, params, x, mask = block_case(16)
    before = (tfb.attention_block_launches.value,
              tfb.attention_block_plain_calls.value)
    with torch.no_grad():
        out = tfb.attention_block(torch.from_numpy(x), params,
                                  port_bias(mask), H, 1e-12)
    assert out.shape == (B, 16, D) and out.dtype == torch.float32
    assert tfb.attention_block_launches.value == before[0]
    assert tfb.attention_block_plain_calls.value == before[1] + 1


# ---------------------------------------------------------------------------
# T1 and T2: the TPU experiments' kernels, taken from their scripts
# ---------------------------------------------------------------------------

def tool_kernels(fname: str, names, scale: float) -> dict:
    """The named definitions nested in `main()` of tools/<fname>, executed
    in a namespace whose `pl.pallas_call` runs in interpret mode."""
    tree = ast.parse((ROOT / "tools" / fname).read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {d.name for d in defs} == set(names)
    ns = {"jax": jax, "jnp": jnp, "functools": functools, "pltpu": pltpu,
          "scale": scale,
          "pl": types.SimpleNamespace(
              pallas_call=functools.partial(pl.pallas_call, interpret=True),
              BlockSpec=pl.BlockSpec)}
    exec(compile(ast.Module(body=defs, type_ignores=[]), fname, "exec"), ns)
    return ns


TB, TL, TH, THD = 8, 10, 2, 64
SCALE = 1.0 / math.sqrt(THD)


def bf16_ulp(a: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(np.abs(a).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_out_matches_bdims_attention(dtype):
    bdims = tool_kernels("exp_attn_layout.py",
                         {"kernel_bdims", "bdims_attention"},
                         SCALE)["bdims_attention"]
    rng = np.random.default_rng(11)
    qkv = [rng.standard_normal((TB, TL, TH, THD)).astype(np.float32)
           for _ in range(3)]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in qkv)
    # the natural (B, L, H, hd) tensors read in place, as (B, H, L, hd)
    got = tfa.attention_fwd(*(t.transpose(1, 2) for t in (q, k, v)), None,
                            SCALE, out_layout="head")
    assert got.shape == (TB, TH, TL, THD) and got.is_contiguous()
    assert got.dtype == tdt
    want = strict(bdims, *(jnp.asarray(t.float().numpy(), getattr(jnp, dtype))
                           for t in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    atol = ATOL_ATT if dtype == "float32" else bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)
    natural = tfa.attention_fwd(*(t.transpose(1, 2) for t in (q, k, v)),
                                None, SCALE)
    assert torch.equal(natural, got)


def test_out_layout_rejects_unknown():
    q = torch.zeros(1, 1, 2, 64)
    with pytest.raises(ValueError, match="out_layout"):
        tfa.attention_fwd(q, q, q, None, 0.125, out_layout="bhld")


@pytest.mark.parametrize("pack", [1, 2])
def test_cheap_plain_matches_cheap_attention(pack):
    cheap = tool_kernels("exp_attn_pack.py",
                         {"kernel_cheap", "cheap_attention"},
                         SCALE)["cheap_attention"]
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((TB, TH, TL, THD)).astype(np.float32)).to(
            torch.bfloat16) for _ in range(3))
    want = strict(functools.partial(cheap, pack=pack),
                  *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                    for t in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    before = (tfa.attention_cheap_launches.value,
              tfa.attention_cheap_plain_calls.value)
    got = tfa.attention_cheap(q, k, v, SCALE)     # the pack = 1 function
    assert tfa.attention_cheap_launches.value == before[0]
    assert tfa.attention_cheap_plain_calls.value == before[1] + 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=bf16_ulp(want))


def test_cheap_takes_bf16_only():
    q = torch.zeros(1, 1, 2, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.attention_cheap(q, q, q, 0.125)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.attention_cheap_plain(q, q, q, 0.125)


# ---------------------------------------------------------------------------
# the two tools end to end on the CPU
# ---------------------------------------------------------------------------

TOOLS = {
    "exp_attn_layout": (exp_attn_layout, {"xla_t", "blhd", "bdims"},
                        {"attention_plain_calls": 3}),
    "exp_attn_pack": (exp_attn_pack, {"v_base", "v_p1bf"},
                      {"attention_plain_calls": 1,
                       "attention_cheap_plain_calls": 1}),
}
COUNTERS = ("attention_fwd_launches", "attention_fwd_head_out_launches",
            "attention_cheap_launches", "attention_plain_calls",
            "attention_cheap_plain_calls")


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_cpu(name):
    mod, variants, plain_variants = TOOLS[name]
    iters = 2
    before = {c: getattr(tfa, c).value for c in COUNTERS}
    res = mod.main(device="cpu", B=8, H=2, L=10, iters=iters)
    counts = {c: getattr(tfa, c).value - before[c] for c in COUNTERS}
    assert res["device"] == "cpu" and res["timer"] == "host clock"
    assert set(res["variants"]) == variants
    # the packed variants are named, not run again
    packed = res.get("no_card_counterpart", {})
    assert set(packed) == ({"v_pack2", "v_p2bf"}
                           if name == "exp_attn_pack" else set())
    for v, r in res["variants"].items():
        assert 0 <= r["max_err"] <= r["tol"], (v, r)
        assert r["ms"] > 0
    # each variant: one checked call, then 4 chained runs of `iters`
    want = {c: plain_variants.get(c, 0) * (1 + 4 * iters) for c in COUNTERS}
    assert counts == want
