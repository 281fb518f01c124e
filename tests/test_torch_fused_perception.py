"""The port's fused perception configuration against the JAX package:
K-GN (`ops/fused_groupnorm.py`), K-PRENORM (`ops/fused_prenorm.py`) and
K-ATT in place of `fused_attention_xbatch`, each module that calls them,
and `perceive` with `DepthEncoderConfig.use_fused_gn` and
`ClipConfig.use_fused_block` set.

Both sides get the same numpy inputs from a seeded generator. The JAX
package gates its Pallas kernels on `jax.default_backend() == "tpu"`, so
on the CPU its fused switches silently take the XLA path; these tests
call the Pallas kernels in interpret mode directly, and at the model
level open the gates inside the test only: the JAX model module sees a
`jax` whose `default_backend()` says "tpu", and the kernel's module
attribute is patched to run in interpret mode (the pattern of
tests/test_pallas_attention.py::test_mha_fused_path_matches_default).
The port runs on the CPU, where each wrapper takes its plain version;
chip_smoke.py holds the CUDA kernels to those plain versions on the GPU.

Tolerances (absolute): 2e-5 in fp32 for values of magnitude ~1 (both
sides fp32, sums in another order); 3e-5 through a whole depth trunk or
perceive (E[x^2] - E[x]^2 over whole feature maps moves the fifth
decimal); 2e-6 for attention alone (tests/test_pallas_attention.py's
tolerance for the kernel); 0.05 in bf16 (tests/test_pallas_groupnorm.py's
bf16 tolerance: one bf16 ulp at magnitude 4-8 is 0.03, and the two sides
may round a value on either side of a tie point). Integer outputs
(candidate slots) must be identical.
"""

import dataclasses
import functools
import inspect
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.models import clip_vit as jclip
from etpnav_tpu.models import depth_resnet as jdepth
from etpnav_tpu.ops import attention as jattn
from etpnav_tpu.ops import basic as jbasic
from etpnav_tpu.ops import pallas_attention as jpa
from etpnav_tpu.ops import pallas_groupnorm as jpg
from etpnav_tpu.training.agent import JittedAgent
from etpnav_tpu.training.agent import init_agent_params as jax_init_agent
from etpnav_tpu_torch.config import r2r_config, tiny_config
from etpnav_tpu_torch.models import clip_vit, depth_resnet
from etpnav_tpu_torch.models.convert import agent_params_from_jax, \
    load_jax_tree
from etpnav_tpu_torch.ops import attention as tattn
from etpnav_tpu_torch.ops import fused_attention as tfa
from etpnav_tpu_torch.ops import fused_groupnorm as tgn
from etpnav_tpu_torch.ops import fused_prenorm as tpre
from etpnav_tpu_torch.ops.basic import LayerNorm

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 2e-5
ATOL_TRUNK = 3e-5
ATOL_BF16 = 0.05

# (B, H, W, C, groups): tests/test_pallas_groupnorm.py's TRUNK_SHAPES —
# stem, layer1..4 block outputs, compression
TRUNK_SHAPES = [
    (2, 64, 64, 32, 16),
    (2, 32, 32, 32, 16), (2, 32, 32, 128, 16),
    (2, 16, 16, 64, 16), (2, 16, 16, 256, 16),
    (2, 8, 8, 128, 16), (2, 8, 8, 512, 16),
    (2, 4, 4, 256, 16), (2, 4, 4, 1024, 16),
    (2, 4, 4, 8, 1),
]


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _nchw(x_nhwc, dtype=torch.float32):
    """NHWC numpy -> the port's (B, C, H, W) view, channels_last in
    memory as the depth trunk's activations are."""
    return _t(x_nhwc).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def random_jax_tree(init_fn, *args, seed=0):
    """The tree a JAX `*_init` function returns (structure and shapes from
    `jax.eval_shape`), filled with seeded numpy values: norm scales near
    1, biases ~0.1, conv kernels He-scaled, every other array std 0.02."""
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
        elif name == "w" and len(s.shape) == 4:
            z = z * np.sqrt(2.0 / np.prod(s.shape[:3]))
        else:
            z = 0.02 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


class _TpuGateJax:
    """`jax` as a JAX model module sees it inside a test: everything is
    jax itself except `default_backend()`, which says "tpu" so the
    module's Pallas gates open."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def jax_gn_interpret(monkeypatch):
    """JAX's `group_norm_fused`, as its callers import it, in interpret
    mode."""
    monkeypatch.setattr(jpg, "group_norm_fused",
                        functools.partial(jpg.group_norm_fused,
                                          interpret=True))


def _gn_pair(rng, C):
    p = {"scale": rng.standard_normal(C).astype(np.float32) + 1.0,
         "bias": rng.standard_normal(C).astype(np.float32)}
    tp = depth_resnet.GroupNorm(C).requires_grad_(False)
    load_jax_tree(tp, p)
    return p, tp


# ---------------------------------------------------------------------------
# K-GN plain version against the Pallas kernel it replaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", TRUNK_SHAPES,
                         ids=[f"{h}x{w}x{c}g{g}" for _, h, w, c, g
                              in TRUNK_SHAPES])
def test_group_norm_plain_matches_pallas_at_trunk_shapes(rng, shape):
    B, H, W, C, G = shape
    x = _rand(rng, B, H, W, C)
    p, tp = _gn_pair(rng, C)
    want = np.asarray(jpg.group_norm_fused(p, jnp.asarray(x), G, relu=True,
                                           interpret=True))
    got = tgn.group_norm_fused(tp, _nchw(x), G, relu=True)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)


@pytest.mark.parametrize("epilogue", ["residual_relu", "neither"])
def test_group_norm_plain_epilogues_match_pallas(rng, epilogue):
    B, H, W, C, G = 2, 8, 8, 64, 16
    x, res = _rand(rng, B, H, W, C), _rand(rng, B, H, W, C)
    p, tp = _gn_pair(rng, C)
    fused = epilogue == "residual_relu"
    want = np.asarray(jpg.group_norm_fused(
        p, jnp.asarray(x), G, relu=fused,
        residual=jnp.asarray(res) if fused else None, interpret=True))
    got = tgn.group_norm_fused(tp, _nchw(x), G, relu=fused,
                               residual=_nchw(res) if fused else None)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)


def test_group_norm_plain_bf16_matches_pallas(rng):
    B, H, W, C, G = 2, 8, 8, 64, 16
    x, res = _rand(rng, B, H, W, C), _rand(rng, B, H, W, C)
    p, tp = _gn_pair(rng, C)
    want = jpg.group_norm_fused(p, jnp.asarray(x, jnp.bfloat16), G,
                                relu=True,
                                residual=jnp.asarray(res, jnp.bfloat16),
                                interpret=True)
    got = tgn.group_norm_fused(tp, _nchw(x, torch.bfloat16), G, relu=True,
                               residual=_nchw(res, torch.bfloat16))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               atol=ATOL_BF16)


# ---------------------------------------------------------------------------
# K-PRENORM plain version against the two Pallas kernels it replaces
# ---------------------------------------------------------------------------

def _prenorm_pair(rng, D):
    attn = jax.tree_util.tree_map(
        np.asarray, jattn.mha_init(jax.random.PRNGKey(1), D))
    for name in ("q", "k", "v", "o"):
        attn[name]["b"] = _rand(rng, D, scale=0.1)
    ln = jax.tree_util.tree_map(np.asarray, jbasic.ln_init(D))
    # a non-trivial LN scale and bias (tests/test_pallas_attention.py:97)
    ln = {"scale": ln["scale"] * 1.1, "bias": ln["bias"] + 0.05}
    t_attn = tattn.MHA(D).requires_grad_(False)
    load_jax_tree(t_attn, attn)
    t_ln = LayerNorm(D).requires_grad_(False)
    load_jax_tree(t_ln, ln)
    return ln, attn, t_ln, t_attn


@pytest.mark.parametrize("kernel", ["v2", "v1"])
def test_prenorm_plain_matches_pallas(rng, kernel):
    B, L, D, H = 6, 50, 64, 4
    x = _rand(rng, B, L, D)
    ln, attn, t_ln, t_attn = _prenorm_pair(rng, D)
    fn = (jpa.fused_prenorm_attention_v2 if kernel == "v2"
          else jpa.fused_prenorm_attention)
    want = np.asarray(fn(jnp.asarray(x), ln, attn, H, 1e-5, block_b=2,
                         interpret=True))
    got = tpre.prenorm_attention(_t(x), t_ln, t_attn, H, 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_prenorm_plain_bf16_matches_pallas_v2(rng):
    """The same rounding points in bf16: LN, each projection and p are
    rounded where the Pallas kernel rounds them."""
    B, L, D, H = 4, 50, 64, 4
    x = _rand(rng, B, L, D)
    ln, attn, t_ln, t_attn = _prenorm_pair(rng, D)
    want = jpa.fused_prenorm_attention_v2(jnp.asarray(x, jnp.bfloat16), ln,
                                          attn, H, 1e-5, block_b=2,
                                          interpret=True)
    got = tpre.prenorm_attention(_t(x).to(torch.bfloat16), t_ln, t_attn, H,
                                 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=ATOL_BF16)


def test_prenorm_plain_matches_port_unfused_half_block(rng):
    """In fp32 the fused op and the port's unfused half-block
    (ln_1, mha through K-ATT, residual) compute the same function."""
    B, L, D, H = 3, 50, 64, 4
    x = _t(_rand(rng, B, L, D))
    _, _, t_ln, t_attn = _prenorm_pair(rng, D)
    a = t_ln(x, 1e-5)
    want = (x + tattn.mha(t_attn, a, a, H)).numpy()
    got = tpre.prenorm_attention(x, t_ln, t_attn, H, 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# K-ATT plain version against fused_attention_xbatch (K8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_b", [1, 2, 3, 4, 6])
def test_attention_plain_matches_xbatch(rng, block_b):
    """Per-sample attention on the natural layout equals the Pallas
    cross-batch block-diagonal GEMM at every batch block
    (tests/test_pallas_attention.py:230's shapes)."""
    B, L, H, hd = 6, 10, 8, 16
    q, k, v = (_rand(rng, B, L, H * hd) for _ in range(3))
    scale = 1.0 / math.sqrt(hd)
    want = np.asarray(jpa.fused_attention_xbatch(
        q, k, v, scale, num_heads=H, block_b=block_b, interpret=True))

    def view(a):
        return _t(a).view(B, L, H, hd).transpose(1, 2)

    got = tfa.attention_fwd(view(q), view(k), view(v), None, scale)
    got = got.transpose(1, 2).reshape(B, L, H * hd).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


# ---------------------------------------------------------------------------
# the modules that call the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_down,stride", [(True, 2), (False, 1)])
def test_fused_bottleneck_matches_jax(rng, jax_gn_interpret, has_down,
                                      stride):
    c_in, planes, exp, G = (16, 8, 4, 4) if has_down else (32, 8, 4, 4)
    jp = random_jax_tree(jdepth._bottleneck_init, c_in, planes, exp,
                         has_down, seed=5)
    tp = depth_resnet.Bottleneck(c_in, planes, exp, has_down)
    load_jax_tree(tp.requires_grad_(False), jp)
    x = _rand(rng, 2, 8, 8, c_in)
    want = np.asarray(jdepth._bottleneck(jp, jnp.asarray(x), stride, G,
                                         fused_gn=True))
    before = tgn.group_norm_plain_calls.value
    got = depth_resnet._bottleneck(tp, _nchw(x), stride, G, fused_gn=True)
    assert tgn.group_norm_plain_calls.value - before == 3 + has_down
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL_TRUNK)


def test_fused_encode_depth_matches_jax(rng, jax_gn_interpret, monkeypatch):
    jcfg = dataclasses.replace(jax_tiny_config().depth, use_fused_gn=True)
    cfg = dataclasses.replace(tiny_config().depth, use_fused_gn=True)
    jp = random_jax_tree(jdepth.init_depth_params, jcfg, seed=2)
    tp = depth_resnet.DepthParams(cfg).requires_grad_(False)
    load_jax_tree(tp, jp)
    dep = rng.random((3, 64, 64, 1)).astype(np.float32)
    monkeypatch.setattr(jdepth, "jax", _TpuGateJax())
    want = np.asarray(jdepth.encode_depth(jp, jcfg, dep,
                                          dtype=jnp.float32))
    before = tgn.group_norm_plain_calls.value
    got = depth_resnet.encode_depth(tp, cfg, _t(dep), dtype=torch.float32)
    # stem + 3 per bottleneck + one per downsample + compression
    assert tgn.group_norm_plain_calls.value - before == (
        1 + 3 * sum(cfg.layers) + 4 + 1)
    assert got.shape == want.shape == (3, 2, 2, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_TRUNK)


def test_fused_clip_tower_matches_jax(rng, monkeypatch):
    """encode_image_uint8 with use_fused_block against JAX's `_trunk` with
    its USE_FUSED_BLOCK gate open and fused_prenorm_attention_v2 in
    interpret mode."""
    jcfg = jax_tiny_config().clip
    cfg = dataclasses.replace(tiny_config().clip, use_fused_block=True)
    jp = random_jax_tree(jclip.init_clip_params, jcfg, seed=1)
    tp = clip_vit.ClipParams(cfg).requires_grad_(False)
    load_jax_tree(tp, jp)
    img = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    monkeypatch.setattr(jclip, "jax", _TpuGateJax())
    monkeypatch.setattr(jclip, "USE_FUSED_BLOCK", True)
    monkeypatch.setattr(jpa, "fused_prenorm_attention_v2",
                        functools.partial(jpa.fused_prenorm_attention_v2,
                                          interpret=True))
    want = np.asarray(jclip.encode_image_uint8(jp, jcfg, img,
                                               dtype=jnp.float32))
    before = tpre.prenorm_attention_plain_calls.value
    got = clip_vit.encode_image_uint8(tp, cfg, _t(img),
                                      dtype=torch.float32).numpy()
    assert tpre.prenorm_attention_plain_calls.value - before == (
        cfg.layers - 1)
    assert got.shape == want.shape == (3, cfg.output_dim)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _fused(cfg):
    return dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, use_fused_block=True),
        depth=dataclasses.replace(cfg.depth, use_fused_gn=True))


def test_fused_perceive_matches_jax(rng):
    """The fused configuration's perceive (fp32, tiny_config) against the
    JAX package's perceive: on the CPU JAX computes the same function
    through XLA."""
    jcfg, cfg = jax_tiny_config(), _fused(tiny_config())
    tree = random_jax_tree(lambda k, c: jax_init_agent(k, c), jcfg, seed=12)
    jparams = type(jax.eval_shape(functools.partial(jax_init_agent,
                                                    cfg=jcfg),
                                  jax.random.PRNGKey(0)))(**tree._asdict())
    jagent = JittedAgent(jcfg, jparams)
    agent = agent_params_from_jax(tree, cfg, device="cpu")
    rgb = rng.integers(0, 256, (2, 12, 32, 32, 3), np.uint8)
    dep = rng.random((2, 12, 64, 64, 1), np.float32)
    counts = (tgn.group_norm_plain_calls.value,
              tpre.prenorm_attention_plain_calls.value)
    got = agent.perceive(rgb, dep)
    # one K-GN per norm of the 24 depth images' trunk, one K-PRENORM per
    # CLIP block but the last: the R2R formula (54 and 11 per call)
    assert (tgn.group_norm_plain_calls.value - counts[0],
            tpre.prenorm_attention_plain_calls.value - counts[1]) == (
        1 + 3 * sum(cfg.depth.layers) + 4 + 1, cfg.clip.layers - 1)
    want = jagent.perceive(rgb, dep)
    assert set(got) == set(want)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        if w.dtype == bool or w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), fin)
            np.testing.assert_allclose(g[fin], w[fin], atol=ATOL_TRUNK,
                                       err_msg=key)
    assert got["cand_valid"].any()


def test_fused_switches_default_off():
    """Both switches keep the JAX package's default: off, so the default
    serving path is PR 1's."""
    for cfg in (r2r_config(), tiny_config()):
        assert not cfg.depth.use_fused_gn
        assert not cfg.clip.use_fused_block
    assert not jax_tiny_config().depth.use_fused_gn
    assert jclip.USE_FUSED_BLOCK is False


# ---------------------------------------------------------------------------
# wrappers: dispatch by device, no library GEMM in K-PRENORM
# ---------------------------------------------------------------------------

def test_wrappers_cpu_take_plain_version(rng):
    x = _nchw(_rand(rng, 1, 4, 4, 8))
    gn = depth_resnet.GroupNorm(8)
    before = (tgn.group_norm_launches.value,
              tgn.group_norm_plain_calls.value)
    tgn.group_norm_fused(gn, x, 4, relu=True)
    assert (tgn.group_norm_launches.value,
            tgn.group_norm_plain_calls.value) == (before[0], before[1] + 1)
    _, _, t_ln, t_attn = _prenorm_pair(rng, 64)
    before = (tpre.prenorm_attention_launches.value,
              tpre.prenorm_attention_plain_calls.value)
    tpre.prenorm_attention(_t(_rand(rng, 2, 5, 64)), t_ln, t_attn, 1, 1e-5)
    assert (tpre.prenorm_attention_launches.value,
            tpre.prenorm_attention_plain_calls.value) == (
        before[0], before[1] + 1)


def test_wrappers_reject_other_devices(rng):
    """Only CPU tensors take the plain version; anything else launches
    the kernel or raises."""
    gn = depth_resnet.GroupNorm(8)
    with pytest.raises(ValueError, match="device"):
        tgn.group_norm_fused(gn, torch.empty(1, 8, 4, 4, device="meta"), 4)
    _, _, t_ln, t_attn = _prenorm_pair(rng, 64)
    with pytest.raises(ValueError, match="device"):
        tpre.prenorm_attention(torch.empty(2, 5, 64, device="meta"), t_ln,
                               t_attn, 1, 1e-5)


def test_prenorm_kernel_path_calls_no_library_gemm():
    """The projections of K-PRENORM are the kernel's own: neither its
    CUDA source, nor the GEMM header it includes, nor its wrapper calls
    cuBLAS, torch.matmul or F.linear."""
    csrc = ROOT / "etpnav_tpu_torch/csrc"
    src = (csrc / "prenorm_attention.cu").read_text()
    assert '#include "dense.cuh"' in src
    src += (csrc / "dense.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "cublas" not in code.lower()
    assert "mma.sync" in code
    wrapper = inspect.getsource(tpre.prenorm_attention)
    for name in ("matmul", "linear", "einsum", "bmm", "@", "mm("):
        assert name not in wrapper, name


def test_group_norm_card_args_refuse_non_channels_last():
    """K-GN reads each sample as one contiguous channels_last slab in
    16-byte vectors of 8 channels: its wrapper's check refuses
    NCHW-contiguous input, a residual whose strides differ from x's, a
    channel count the vectors do not tile and a misaligned base."""
    gn = depth_resnet.GroupNorm(8)
    x = torch.zeros(2, 8, 4, 4)
    with pytest.raises(ValueError, match="channels_last"):
        tgn.check_card_args(gn, x, 4, None)
    xc = x.to(memory_format=torch.channels_last)
    tgn.check_card_args(gn, xc, 4, None)
    tgn.check_card_args(gn, xc, 4, torch.zeros_like(xc))
    with pytest.raises(ValueError, match="residual"):
        tgn.check_card_args(gn, xc, 4, x)
    with pytest.raises(ValueError, match="channels"):
        tgn.check_card_args(depth_resnet.GroupNorm(12), torch.zeros(
            2, 12, 4, 4).to(memory_format=torch.channels_last), 4, None)
    with pytest.raises(ValueError, match="aligned"):
        tgn.check_card_args(gn, torch.zeros(1 + 2 * 4 * 4 * 8)[1:].view(
            2, 4, 4, 8).permute(0, 3, 1, 2), 4, None)


def _code(name: str) -> str:
    src = (ROOT / "etpnav_tpu_torch/csrc" / name).read_text()
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def test_bf16_weight_rounding_is_nearest_even(rng):
    """The bf16 chains of K-PRENORM and K-BLOCK round their fp32 weights
    once per call (`round_bf16_kernel`, through `pack_bf16`, i.e.
    `__floats2bfloat162_rn`) before any GEMM. Nearest even on the fp32
    bits, ties included, is `.to(torch.bfloat16)`, the plain versions'
    cast and `round_bf16`'s CPU version; chip_smoke.py holds the kernel
    to it bit for bit on the card."""
    dense = _code("dense.cuh")
    body = dense[dense.index("round_bf16_kernel(RoundArgs"):]
    body = body[:body.index("\n}\n")]
    assert "pack_bf16(v.x, v.y)" in body and "pack_bf16(v.z, v.w)" in body
    pack = dense[dense.index("uint32_t pack_bf16("):]
    assert "__floats2bfloat162_rn(lo, hi)" in pack[:pack.index("}")]
    for name in ("prenorm_attention.cu", "attention_block.cu"):
        chain = _code(name)
        chain = chain[chain.index("int run_chain("):]
        assert (chain.index("launch_round_bf16(w, 4, D * D, w_bf16")
                < chain.index("launch_gemm")), name
    w = rng.standard_normal(4096).astype(np.float32)
    u = w.view(np.uint32)
    u[:1024] = (u[:1024] & 0xFFFF0000) | 0x8000       # exact ties
    u[1024:2048] = (u[1024:2048] & 0xFFFF0000) | 0x7FFF
    rne = ((u.astype(np.uint64) + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    want = rne.astype(np.uint32).view(np.float32)
    got = tpre.round_bf16(torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
